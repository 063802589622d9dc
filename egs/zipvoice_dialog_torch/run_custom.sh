#!/usr/bin/env bash
# Train ZipVoice-Dialog on a custom two-speaker dataset.
# Mirrors the reference egs/zipvoice_dialog/run_custom.sh.
#
# Data format: TSV lines  id<TAB>text<TAB>wav  where text interleaves
# speaker turns as "[S1] ... [S2] ... [S1] ...".
set -euo pipefail

stage=${stage:-1}
stop_stage=${stop_stage:-7}
platform=${platform:-cuda}  # torch device of the models: cuda or cpu
nj=${nj:-8}

download_dir=${download_dir:-download}
exp_dir=${exp_dir:-exp/zipvoice_dialog_custom}
token_file=${token_file:-$download_dir/zipvoice_dialog/tokens.txt}

log() { echo "$(date '+%F %T') $*"; }

for subset in train dev; do
  f=data/raw/custom_dialog_${subset}.tsv
  [ -f "$f" ] || { echo "Error: expect $f !" >&2; exit 1; }
done

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "stage 1: prepare manifests from TSVs"
  for subset in train dev; do
    python -m zipvoice_torch.bin.prepare_dataset \
      --tsv-path data/raw/custom_dialog_${subset}.tsv \
      --prefix custom-dialog --subset "$subset" \
      --num-jobs "$nj" --output-dir data/manifests
  done
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: tokenize manifests (dialog tokenizer)"
  for subset in train dev; do
    python -m zipvoice_torch.bin.prepare_tokens \
      --manifest data/manifests/custom-dialog_cuts_${subset}.jsonl.gz \
      --tokenizer dialog
  done
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: compute fbank features"
  for subset in train dev; do
    python -m zipvoice_torch.bin.compute_fbank \
      --manifest data/manifests/custom-dialog_cuts_${subset}.jsonl.gz \
      --output-dir "data/fbank/custom-dialog_${subset}" --num-jobs "$nj"
  done
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: verify pre-trained base model + dialog token file"
  for f in "$download_dir/zipvoice/model.pt" \
           "$download_dir/zipvoice/model.json" "$token_file"; do
    [ -f "$f" ] || {
      echo "missing $f — place the k2-fsa/ZipVoice release on disk" >&2
      exit 1
    }
  done
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  log "stage 5: train ZipVoice-Dialog (init from base ZipVoice)"
  python -m zipvoice_torch.bin.train_zipvoice \
    --model-name zipvoice_dialog \
    --init-from-base "$download_dir/zipvoice/model.pt" \
    --model-config "$download_dir/zipvoice/model.json" \
    --token-file "$token_file" --tokenizer dialog \
    --train-manifest data/manifests/custom-dialog_cuts_train.jsonl.gz \
    --dev-manifest data/manifests/custom-dialog_cuts_dev.jsonl.gz \
    --scheduler fixed --base-lr 0.0001 \
    --num-iters 60000 --save-every-n 5000 \
    --max-duration 500 --max-len 60 \
    --exp-dir "$exp_dir" \
    --platform "$platform"
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  log "stage 6: average the checkpoints"
  python -m zipvoice_torch.bin.generate_averaged_model \
    --exp-dir "$exp_dir" --iter 60000 --avg 2 \
    --out "$exp_dir/model.pt"
fi

if [ $stage -le 7 ] && [ $stop_stage -ge 7 ]; then
  log "stage 7: inference"
  python -m zipvoice_torch.bin.infer_zipvoice_dialog \
    --model-name zipvoice_dialog --model-dir "$exp_dir" \
    --test-list test.tsv --res-dir results/test_dialog \
    --platform "$platform"
fi
