#!/usr/bin/env bash
# Fine-tune ZipVoice on a custom dataset from a pre-trained checkpoint.
# Mirrors the 7 stages of the reference egs/zipvoice/run_finetune.sh.
#
# Expects:
#   data/raw/custom_train.tsv, data/raw/custom_dev.tsv
#     (lines: id<TAB>text<TAB>wav[<TAB>start<TAB>end])
#   $download_dir/zipvoice/{model.pt,model.json,tokens.txt}
#     (the published k2-fsa/ZipVoice release; no network here — place it
#      on disk, or point --checkpoint at a model.pt of this recipe)
set -euo pipefail

stage=${stage:-1}
stop_stage=${stop_stage:-7}
platform=${platform:-cuda}  # torch device of the models: cuda or cpu
nj=${nj:-8}

# emilia tokenizer for zh/en data; espeak + lang=<code> otherwise
is_zh_en=${is_zh_en:-1}
lang=${lang:-default}
if [ "$is_zh_en" -eq 1 ]; then
  tokenizer=emilia
  lang=en-us
else
  tokenizer=espeak
  [ "$lang" = "default" ] && { echo "Error: lang is not set!" >&2; exit 1; }
fi

# filter out utterances longer than this many seconds (set to the 99th
# percentile duration of your corpus)
max_len=${max_len:-20}
download_dir=${download_dir:-download}
exp_dir=${exp_dir:-exp/zipvoice_finetune}

log() { echo "$(date '+%F %T') $*"; }

for subset in train dev; do
  f=data/raw/custom_${subset}.tsv
  [ -f "$f" ] || { echo "Error: expect $f !" >&2; exit 1; }
done

### Prepare the training data (1 - 3)

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "stage 1: prepare manifests from TSVs"
  for subset in train dev; do
    python -m zipvoice_torch.bin.prepare_dataset \
      --tsv-path data/raw/custom_${subset}.tsv \
      --prefix custom-finetune --subset "$subset" \
      --num-jobs "$nj" --output-dir data/manifests
  done
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: tokenize manifests (offline; on-the-fly G2P slows training)"
  for subset in train dev; do
    python -m zipvoice_torch.bin.prepare_tokens \
      --manifest data/manifests/custom-finetune_cuts_${subset}.jsonl.gz \
      --tokenizer "$tokenizer" --lang "$lang"
  done
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: compute fbank (skippable with --on-the-fly-feats)"
  for subset in train dev; do
    python -m zipvoice_torch.bin.compute_fbank \
      --manifest data/manifests/custom-finetune_cuts_${subset}.jsonl.gz \
      --output-dir data/fbank/custom-finetune_${subset} --num-jobs "$nj"
  done
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: verify the pre-trained model is on disk"
  for file in model.pt model.json tokens.txt; do
    [ -f "$download_dir/zipvoice/$file" ] || {
      echo "missing $download_dir/zipvoice/$file — download the" \
           "k2-fsa/ZipVoice release (huggingface) onto this machine" >&2
      exit 1
    }
  done
fi

### Fine-tune (5 - 6)

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  log "stage 5: fine-tune ZipVoice (fixed LR, 10k iters)"
  python -m zipvoice_torch.bin.train_zipvoice \
    --checkpoint "$download_dir/zipvoice/model.pt" \
    --model-config "$download_dir/zipvoice/model.json" \
    --token-file "$download_dir/zipvoice/tokens.txt" \
    --tokenizer "$tokenizer" --lang "$lang" \
    --train-manifest data/manifests/custom-finetune_cuts_train.jsonl.gz \
    --dev-manifest data/manifests/custom-finetune_cuts_dev.jsonl.gz \
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

### Inference (7)

if [ $stage -le 7 ] && [ $stop_stage -ge 7 ]; then
  log "stage 7: inference with the fine-tuned model"
  python -m zipvoice_torch.bin.infer_zipvoice \
    --model-name zipvoice --model-dir "$exp_dir" \
    --test-list test.tsv --res-dir results/test_finetune \
    --num-step 16 \
    --platform "$platform"
fi
