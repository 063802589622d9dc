#!/usr/bin/env bash
# Train ZipVoice + ZipVoice-Distill on the Emilia corpus, end to end, with
# the PyTorch port (zipvoice_torch) on NVIDIA GPUs.
# Mirrors the 12 stages of the reference egs/zipvoice/run_emilia.sh:
# data prep, base training, checkpoint averaging, two-stage distillation,
# engine export (the reference's onnx_export role -> torch.export programs
# replayed as CUDA graphs), and inference with both the native and the
# exported models.
set -euo pipefail

stage=${stage:-1}
stop_stage=${stop_stage:-12}

token_file=${token_file:-data/tokens_emilia.txt}
test_list=${test_list:-test.tsv}
# data-parallel width (the reference's --world-size): this many training
# processes, one a GPU, in one process group at $coordinator
num_dp=${num_dp:-1}
coordinator=${coordinator:-127.0.0.1:29500}
platform=${platform:-cuda}

log() { echo "$(date '+%F %T') $*"; }

# run a trainer command as $num_dp processes (process i drives GPU i) and
# wait for all of them
train() {
  if [ "$num_dp" -le 1 ]; then
    "$@" --platform "$platform"
    return
  fi
  local pids=() i
  for ((i = 0; i < num_dp; i++)); do
    "$@" --platform "$platform" --coordinator-address "$coordinator" \
      --num-processes "$num_dp" --process-id "$i" &
    pids+=($!)
  done
  for i in "${pids[@]}"; do
    wait "$i"
  done
}

#### Prepare the Emilia dataset (1)

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "stage 1: data preparation for the Emilia dataset"
  bash local/prepare_emilia.sh
fi

### Train ZipVoice (2 - 3)

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: train the ZipVoice model"
  # EN/ZH manifests are muxed with the reference's weights
  # (train_zipvoice.py:1000-1011: [46000, 49000])
  train python -m zipvoice_torch.bin.train_zipvoice \
    --train-manifest data/manifests/emilia_en_cuts_train.jsonl.gz \
    --train-manifest data/manifests/emilia_zh_cuts_train.jsonl.gz \
    --train-weight 46000 --train-weight 49000 \
    --dev-manifest data/manifests/emilia_en_cuts_dev.jsonl.gz \
    --model-config conf/zipvoice_base.json \
    --tokenizer emilia --token-file "$token_file" \
    --num-epochs 11 --max-duration 500 --lr-hours 30000 \
    --streaming --num-workers 8 --shuffle-buffer 20000 \
    --exp-dir exp/zipvoice
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: average the checkpoints for ZipVoice (exp/zipvoice/model.pt)"
  python -m zipvoice_torch.bin.generate_averaged_model \
    --exp-dir exp/zipvoice --epoch 11 --avg 4 \
    --out exp/zipvoice/model.pt
fi

#### (Optional) two-stage ZipVoice-Distill training (4 - 6)

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: train the ZipVoice-Distill model (first stage)"
  train python -m zipvoice_torch.bin.train_zipvoice_distill \
    --distill-stage first \
    --teacher-checkpoint exp/zipvoice/model.pt \
    --train-manifest data/manifests/emilia_en_cuts_train.jsonl.gz \
    --train-manifest data/manifests/emilia_zh_cuts_train.jsonl.gz \
    --train-weight 46000 --train-weight 49000 \
    --tokenizer emilia --token-file "$token_file" \
    --num-iters 60000 --max-duration 500 --base-lr 0.0005 \
    --save-every-n 10000 \
    --exp-dir exp/zipvoice_distill_1stage
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  log "stage 5: average the checkpoints for ZipVoice-Distill (first stage)"
  python -m zipvoice_torch.bin.generate_averaged_model \
    --exp-dir exp/zipvoice_distill_1stage --iter 60000 --avg 7 \
    --out exp/zipvoice_distill_1stage/iter-60000-avg-7.pt
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  log "stage 6: train the ZipVoice-Distill model (second stage, EMA teacher)"
  train python -m zipvoice_torch.bin.train_zipvoice_distill \
    --distill-stage second \
    --checkpoint exp/zipvoice_distill_1stage/iter-60000-avg-7.pt \
    --model-config conf/zipvoice_base.json \
    --train-manifest data/manifests/emilia_en_cuts_train.jsonl.gz \
    --train-manifest data/manifests/emilia_zh_cuts_train.jsonl.gz \
    --train-weight 46000 --train-weight 49000 \
    --tokenizer emilia --token-file "$token_file" \
    --num-iters 2000 --max-duration 500 --base-lr 0.0001 \
    --save-every-n 1000 \
    --exp-dir exp/zipvoice_distill
  # the release model the later stages load (exp/zipvoice_distill/model.pt)
  python -m zipvoice_torch.bin.generate_averaged_model \
    --exp-dir exp/zipvoice_distill --iter 2000 --avg 1
fi

### Export AOT engines (7 - 8) — the reference's ONNX/TensorRT export role

if [ $stage -le 7 ] && [ $stop_stage -ge 7 ]; then
  log "stage 7: export ZipVoice engines (torch.export programs)"
  python -m zipvoice_torch.bin.export_model \
    --model-name zipvoice --model-dir exp/zipvoice \
    --num-step 16 --guidance-scale 1.0 \
    --out-dir exp/zipvoice/engines --platform "$platform"
fi

if [ $stage -le 8 ] && [ $stop_stage -ge 8 ]; then
  log "stage 8: export ZipVoice-Distill engines"
  python -m zipvoice_torch.bin.export_model \
    --model-name zipvoice_distill --model-dir exp/zipvoice_distill \
    --num-step 8 --guidance-scale 3.0 \
    --out-dir exp/zipvoice_distill/engines --platform "$platform"
fi

### Inference with native and exported models (9 - 12)

if [ $stage -le 9 ] && [ $stop_stage -ge 9 ]; then
  log "stage 9: inference with the ZipVoice model"
  python -m zipvoice_torch.bin.infer_zipvoice \
    --model-name zipvoice --model-dir exp/zipvoice \
    --test-list "$test_list" --res-dir results/test \
    --num-step 16 --guidance-scale 1.0 --raw-evaluation \
    --platform "$platform"
fi

if [ $stage -le 10 ] && [ $stop_stage -ge 10 ]; then
  log "stage 10: inference with the ZipVoice-Distill model"
  python -m zipvoice_torch.bin.infer_zipvoice \
    --model-name zipvoice_distill --model-dir exp/zipvoice_distill \
    --test-list "$test_list" --res-dir results/test_distill \
    --num-step 8 --guidance-scale 3.0 --raw-evaluation \
    --platform "$platform"
fi

if [ $stage -le 11 ] && [ $stop_stage -ge 11 ]; then
  log "stage 11: inference with the exported ZipVoice engines"
  python -m zipvoice_torch.bin.infer_exported \
    --engine-dir exp/zipvoice/engines --model-dir exp/zipvoice \
    --model-name zipvoice \
    --prompt-wav "${prompt_wav:?set prompt_wav}" \
    --prompt-text "${prompt_text:?set prompt_text}" \
    --text "${text:-Hello from ZipVoice.}" \
    --res-wav-path results/test_exported.wav --platform "$platform"
fi

if [ $stage -le 12 ] && [ $stop_stage -ge 12 ]; then
  log "stage 12: inference with the exported ZipVoice-Distill engines"
  python -m zipvoice_torch.bin.infer_exported \
    --engine-dir exp/zipvoice_distill/engines --model-dir exp/zipvoice_distill \
    --model-name zipvoice_distill \
    --prompt-wav "${prompt_wav:?set prompt_wav}" \
    --prompt-text "${prompt_text:?set prompt_text}" \
    --text "${text:-Hello from ZipVoice.}" \
    --res-wav-path results/test_distill_exported.wav --platform "$platform"
fi
