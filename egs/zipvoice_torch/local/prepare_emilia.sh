#!/usr/bin/env bash
# Emilia data preparation (mirror of the reference
# egs/zipvoice/local/prepare_emilia.sh): corpus metadata -> TSVs ->
# manifests -> fbank features -> tokens -> token vocabulary.
#
# Expects the Emilia corpus on disk (https://huggingface.co/datasets/amphion/Emilia-Dataset);
# this environment has no network, so presence is only verified.
set -euo pipefail

stage=${stage:-1}
stop_stage=${stop_stage:-5}
emilia_root=${emilia_root:-download/Emilia-Dataset}
nj=${nj:-8}

log() { echo "$(date '+%F %T') $*"; }

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "stage 1: filter corpus metadata (zh/en, DNSMOS) into TSVs"
  [ -d "$emilia_root" ] || {
    echo "Emilia corpus not found at $emilia_root" >&2; exit 1
  }
  python local/preprocess_emilia.py \
    --jsonl "$emilia_root"/meta/*.jsonl \
    --wav-root "$emilia_root" \
    --output-dir data/raw
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: build cut manifests"
  for lang in en zh; do
    for subset in train dev; do
      tsv=data/raw/emilia_${lang}_${subset}.tsv
      [ -f "$tsv" ] || continue
      python -m zipvoice_torch.bin.prepare_dataset \
        --tsv-path "$tsv" --prefix "emilia_${lang}" --subset "$subset" \
        --output-dir data/manifests --num-jobs "$nj"
    done
  done
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: compute vocos fbank features (.fz codec)"
  for lang in en zh; do
    for subset in train dev; do
      m=data/manifests/emilia_${lang}_cuts_${subset}.jsonl.gz
      [ -f "$m" ] || continue
      python -m zipvoice_torch.bin.compute_fbank \
        --manifest "$m" --output-dir "data/fbank/emilia_${lang}_${subset}" \
        --num-jobs "$nj"
    done
  done
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: tokenize manifests (emilia tokenizer: jieba/pinyin zh + espeak en)"
  for lang in en zh; do
    for subset in train dev; do
      m=data/manifests/emilia_${lang}_cuts_${subset}.jsonl.gz
      [ -f "$m" ] || continue
      python -m zipvoice_torch.bin.prepare_tokens --manifest "$m" --tokenizer emilia
    done
  done
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  log "stage 5: build the emilia token vocabulary (pinyin table + espeak IPA)"
  python local/build_emilia_tokens.py \
    --output data/tokens_emilia.txt \
    $(for lang in en zh; do
        m=data/manifests/emilia_${lang}_cuts_train.jsonl.gz
        [ -f "$m" ] && echo --manifest "$m"
      done)
fi
