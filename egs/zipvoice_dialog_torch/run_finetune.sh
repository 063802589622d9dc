#!/usr/bin/env bash
# Fine-tune ZipVoice-Dialog on a custom two-speaker dataset from the
# published dialog checkpoint.  Mirrors the 7 stages of the reference
# egs/zipvoice_dialog/run_finetune.sh.
#
# Data format: TSV lines  id<TAB>text<TAB>wav  with "[S1] ... [S2] ..."
# speaker-turn interleaved text.
set -euo pipefail

stage=${stage:-1}
stop_stage=${stop_stage:-7}
platform=${platform:-cuda}  # torch device of the models: cuda or cpu
nj=${nj:-8}
max_len=${max_len:-60}
download_dir=${download_dir:-download}
exp_dir=${exp_dir:-exp/zipvoice_dialog_finetune}

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
      --prefix dialog-finetune --subset "$subset" \
      --num-jobs "$nj" --output-dir data/manifests
  done
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: tokenize manifests"
  for subset in train dev; do
    python -m zipvoice_torch.bin.prepare_tokens \
      --manifest data/manifests/dialog-finetune_cuts_${subset}.jsonl.gz \
      --tokenizer dialog
  done
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: compute fbank features"
  for subset in train dev; do
    python -m zipvoice_torch.bin.compute_fbank \
      --manifest data/manifests/dialog-finetune_cuts_${subset}.jsonl.gz \
      --output-dir "data/fbank/dialog-finetune_${subset}" --num-jobs "$nj"
  done
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: verify the pre-trained dialog model on disk"
  for file in model.pt model.json tokens.txt; do
    [ -f "$download_dir/zipvoice_dialog/$file" ] || {
      echo "missing $download_dir/zipvoice_dialog/$file" >&2; exit 1
    }
  done
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  log "stage 5: fine-tune ZipVoice-Dialog (fixed LR, 10k iters)"
  python -m zipvoice_torch.bin.train_zipvoice \
    --model-name zipvoice_dialog \
    --checkpoint "$download_dir/zipvoice_dialog/model.pt" \
    --model-config "$download_dir/zipvoice_dialog/model.json" \
    --token-file "$download_dir/zipvoice_dialog/tokens.txt" \
    --tokenizer dialog \
    --train-manifest data/manifests/dialog-finetune_cuts_train.jsonl.gz \
    --dev-manifest data/manifests/dialog-finetune_cuts_dev.jsonl.gz \
    --scheduler fixed --base-lr 0.0001 \
    --num-iters 10000 --save-every-n 1000 \
    --max-duration 500 --max-len "$max_len" \
    --exp-dir "$exp_dir" \
    --platform "$platform"
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  log "stage 6: average the checkpoints"
  python -m zipvoice_torch.bin.generate_averaged_model \
    --exp-dir "$exp_dir" --iter 10000 --avg 2 \
    --out "$exp_dir/model.pt"
fi

if [ $stage -le 7 ] && [ $stop_stage -ge 7 ]; then
  log "stage 7: inference with the fine-tuned model"
  python -m zipvoice_torch.bin.infer_zipvoice_dialog \
    --model-name zipvoice_dialog --model-dir "$exp_dir" \
    --test-list test.tsv --res-dir results/test_dialog_finetune \
    --platform "$platform"
fi
