#!/usr/bin/env bash
# LibriTTS recipe (mirror of the reference egs/zipvoice/run_libritts.sh).
# Requires the LibriTTS corpus on disk (https://www.openslr.org/60/);
# this environment has no network, so stage 0 only verifies presence.
set -euo pipefail

stage=${stage:-0}
stop_stage=${stop_stage:-6}
platform=${platform:-cuda}  # torch device of the models: cuda or cpu
libritts_root=${libritts_root:-download/LibriTTS}
exp_dir=${exp_dir:-exp/zipvoice_libritts}
token_file=${token_file:-data/tokens_libritts.txt}

log() { echo "$(date '+%F %T') $*"; }

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ]; then
  [ -d "$libritts_root" ] || {
    echo "LibriTTS not found at $libritts_root; download from openslr.org/60"
    exit 1
  }
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "stage 1: build TSVs from the corpus layout"
  mkdir -p data/raw
  for subset in train-clean-100 train-clean-360 dev-clean; do
    find "$libritts_root/$subset" -name '*.wav' | while read -r wav; do
      txt="${wav%.wav}.normalized.txt"
      [ -f "$txt" ] || continue
      printf '%s\t%s\t%s\n' "$(basename "${wav%.wav}")" "$(cat "$txt")" "$wav"
    done > "data/raw/libritts_${subset}.tsv"
  done
  cat data/raw/libritts_train-*.tsv > data/raw/libritts_train.tsv
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: manifests + features + tokens"
  python -m zipvoice_torch.bin.prepare_dataset \
    --tsv-path data/raw/libritts_train.tsv --prefix libritts \
    --subset train --output-dir data/manifests
  python -m zipvoice_torch.bin.prepare_dataset \
    --tsv-path data/raw/libritts_dev-clean.tsv --prefix libritts \
    --subset dev --output-dir data/manifests
  for subset in train dev; do
    python -m zipvoice_torch.bin.compute_fbank \
      --manifest "data/manifests/libritts_cuts_${subset}.jsonl.gz" \
      --output-dir "data/fbank_libritts/${subset}"
    python -m zipvoice_torch.bin.prepare_tokens \
      --manifest "data/manifests/libritts_cuts_${subset}.jsonl.gz" \
      --tokenizer libritts
  done
  python -m zipvoice_torch.bin.build_tokens \
    --manifest data/manifests/libritts_cuts_train.jsonl.gz \
    --output "$token_file"
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: train"
  python -m zipvoice_torch.bin.train_zipvoice \
    --train-manifest data/manifests/libritts_cuts_train.jsonl.gz \
    --dev-manifest data/manifests/libritts_cuts_dev.jsonl.gz \
    --token-file "$token_file" --tokenizer libritts \
    --exp-dir "$exp_dir" --num-epochs 11 --max-duration 250 \
    --platform "$platform"
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: average into a release dir (model.pt, model.json, tokens.txt)"
  # the averaged .pt is already in the reference layout: no export step
  mkdir -p "$exp_dir/release"
  python -m zipvoice_torch.bin.generate_averaged_model \
    --exp-dir "$exp_dir" --epoch 11 --avg 4 --out "$exp_dir/release/model.pt"
  cp "$exp_dir/model.json" "$exp_dir/tokens.txt" "$exp_dir/release/"
fi
