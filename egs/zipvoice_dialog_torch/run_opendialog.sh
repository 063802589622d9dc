#!/usr/bin/env bash
# Train ZipVoice-Dialog on the OpenDialog corpus (~100h en + zh two-speaker
# conversations).  Mirrors the 7 stages of the reference
# egs/zipvoice_dialog/run_opendialog.sh.
#
# Expects OpenDialog on disk (huggingface.co/datasets/k2-fsa/OpenDialog)
# and a pre-trained base ZipVoice model as the initialization.
set -euo pipefail

stage=${stage:-1}
stop_stage=${stop_stage:-7}
platform=${platform:-cuda}  # torch device of the models: cuda or cpu
nj=${nj:-8}

data_dir=${data_dir:-download/OpenDialog}
download_dir=${download_dir:-download}
exp_dir=${exp_dir:-exp/zipvoice_dialog_opendialog}
# dialog token file = emilia tokens + 28 dialog tokens ([S1]/[S2], ...)
token_file=${token_file:-$download_dir/zipvoice_dialog/tokens.txt}

log() { echo "$(date '+%F %T') $*"; }

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "stage 1: prepare manifests from the OpenDialog metadata"
  python local/prepare_opendialog.py \
    --dataset-path "$data_dir" --num-jobs "$nj" \
    --output-dir data/manifests
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: tokenize manifests (dialog tokenizer: [S1]/[S2] turns)"
  for subset in ZH-dev ZH-train EN-dev EN-train; do
    m=data/manifests/opendialog_cuts_raw_${subset}.jsonl.gz
    [ -f "$m" ] || continue
    python -m zipvoice_torch.bin.prepare_tokens --manifest "$m" --tokenizer dialog
  done
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: compute fbank features"
  for subset in ZH-dev ZH-train EN-dev EN-train; do
    m=data/manifests/opendialog_cuts_raw_${subset}.jsonl.gz
    [ -f "$m" ] || continue
    python -m zipvoice_torch.bin.compute_fbank \
      --manifest "$m" --output-dir "data/fbank/opendialog_${subset}" \
      --num-jobs "$nj"
  done
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: verify the pre-trained base model + dialog token file"
  for f in "$download_dir/zipvoice/model.pt" \
           "$download_dir/zipvoice/model.json" "$token_file"; do
    [ -f "$f" ] || {
      echo "missing $f — place the k2-fsa/ZipVoice release on disk" >&2
      exit 1
    }
  done
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  log "stage 5: train ZipVoice-Dialog (init from base, vocab extended +28)"
  python -m zipvoice_torch.bin.train_zipvoice \
    --model-name zipvoice_dialog \
    --init-from-base "$download_dir/zipvoice/model.pt" \
    --model-config "$download_dir/zipvoice/model.json" \
    --token-file "$token_file" --tokenizer dialog \
    --train-manifest data/manifests/opendialog_cuts_raw_EN-train.jsonl.gz \
    --train-manifest data/manifests/opendialog_cuts_raw_ZH-train.jsonl.gz \
    --dev-manifest data/manifests/opendialog_cuts_raw_EN-dev.jsonl.gz \
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
  log "stage 7: inference with the ZipVoice-Dialog model"
  python -m zipvoice_torch.bin.infer_zipvoice_dialog \
    --model-name zipvoice_dialog --model-dir "$exp_dir" \
    --test-list test.tsv --res-dir results/test_dialog \
    --platform "$platform"
fi
