#!/usr/bin/env bash
# Train ZipVoice on a custom dataset, end to end.
# Mirrors the reference recipe egs/zipvoice/run_custom.sh (stage runner).
#
# Data format: TSV with lines  id<TAB>text<TAB>wav[<TAB>start<TAB>end]
set -euo pipefail

stage=${stage:-1}
stop_stage=${stop_stage:-6}
platform=${platform:-cuda}  # torch device of the models: cuda or cpu

train_tsv=${train_tsv:-data/raw/train.tsv}
dev_tsv=${dev_tsv:-data/raw/dev.tsv}
token_file=${token_file:-data/tokens.txt}
exp_dir=${exp_dir:-exp/zipvoice_custom}
tokenizer=${tokenizer:-emilia}
max_duration=${max_duration:-250}
num_epochs=${num_epochs:-11}

log() { echo "$(date '+%F %T') $*"; }

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "stage 1: prepare manifests"
  python -m zipvoice_torch.bin.prepare_dataset \
    --tsv-path "$train_tsv" --prefix custom --subset train \
    --output-dir data/manifests
  python -m zipvoice_torch.bin.prepare_dataset \
    --tsv-path "$dev_tsv" --prefix custom --subset dev \
    --output-dir data/manifests
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: compute fbank features"
  for subset in train dev; do
    python -m zipvoice_torch.bin.compute_fbank \
      --manifest "data/manifests/custom_cuts_${subset}.jsonl.gz" \
      --output-dir "data/fbank/${subset}"
  done
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: tokenize"
  for subset in train dev; do
    python -m zipvoice_torch.bin.prepare_tokens \
      --manifest "data/manifests/custom_cuts_${subset}.jsonl.gz" \
      --tokenizer "$tokenizer"
  done
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: train"
  python -m zipvoice_torch.bin.train_zipvoice \
    --train-manifest data/manifests/custom_cuts_train.jsonl.gz \
    --dev-manifest data/manifests/custom_cuts_dev.jsonl.gz \
    --token-file "$token_file" --tokenizer "$tokenizer" \
    --exp-dir "$exp_dir" --num-epochs "$num_epochs" \
    --max-duration "$max_duration" \
    --platform "$platform"
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  log "stage 5: average checkpoints into $exp_dir/model.pt"
  python -m zipvoice_torch.bin.generate_averaged_model \
    --exp-dir "$exp_dir" --epoch "$num_epochs" --avg 4 \
    --out "$exp_dir/model.pt"
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  log "stage 6: test inference"
  python -m zipvoice_torch.bin.infer_zipvoice \
    --model-dir "$exp_dir" \
    --prompt-wav "${prompt_wav:?set prompt_wav}" \
    --prompt-text "${prompt_text:?set prompt_text}" \
    --text "${text:-Hello from ZipVoice.}" \
    --res-wav-path "$exp_dir/test.wav" \
    --platform "$platform"
fi
