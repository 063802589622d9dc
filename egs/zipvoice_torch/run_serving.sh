#!/usr/bin/env bash
# Serving deployment pipeline.  Mirrors the reference's
# runtime/nvidia_triton/run.sh stages (TRT engine build -> model repo ->
# serve -> bench) with the PyTorch port on an NVIDIA GPU: engine export
# (torch.export programs, replayed as CUDA graphs) -> HTTP/gRPC server with
# micro-batching + speaker cache -> bench clients.
#
#   model_dir=exp/zipvoice_distill/release bash run_serving.sh
#
# Stages:
#   1  export engines at the serving shape buckets (bf16, as served)
#   2  launch the HTTP server (--engine-dir, OpenAI-compatible route)
#   3  HTTP bench sweep (concurrency, latency percentiles)
#   4  launch the gRPC server (unary + streaming)
#   5  gRPC bench (P50/P90/P99 + streaming time-to-first-audio)
set -euo pipefail

stage=${stage:-1}
stop_stage=${stop_stage:-5}
platform=${platform:-cuda}  # torch device of the models: cuda or cpu

model_dir=${model_dir:?set model_dir=<release dir with model.pt/model.json/tokens.txt>}
model_name=${model_name:-zipvoice_distill}
engine_dir=${engine_dir:-${model_dir}/engines}
port=${port:-8000}
grpc_port=${grpc_port:-50051}
num_step=${num_step:-4}
guidance_scale=${guidance_scale:-3.0}
# B:S:T buckets to pre-export; the server logs "sample bucket B= S= T="
# lines (and "engine miss" when --engine-dir lacks one) to refine this
buckets=${buckets:-"1:96:512,2:96:512,4:96:512,8:96:512"}
prompt_wav=${prompt_wav:?set prompt_wav=<reference voice wav>}
prompt_text=${prompt_text:?set prompt_text=<its transcript>}
quantize=${quantize:-}   # "int8" for weight-only quantized serving

log() { echo "$(date '+%F %T') $*"; }
qflag=""
[ -n "$quantize" ] && qflag="--quantize $quantize"

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "stage 1: engine export -> $engine_dir"
  python -m zipvoice_torch.bin.export_model \
    --model-dir "$model_dir" --model-name "$model_name" \
    --out-dir "$engine_dir" --buckets "$buckets" \
    --num-step "$num_step" --guidance-scale "$guidance_scale" --bf16 \
    --platform "$platform"
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "stage 2: HTTP server on :$port (engines + warmup)"
  python -m zipvoice_torch.serving.server \
    --model-dir "$model_dir" --model-name "$model_name" \
    --engine-dir "$engine_dir" --port "$port" \
    --num-step "$num_step" --guidance-scale "$guidance_scale" \
    --warmup $qflag --platform "$platform" &
  HTTP_PID=$!
  for i in $(seq 1 300); do
    curl -s -m 2 "localhost:$port/health" >/dev/null 2>&1 && break
    sleep 1
  done
  log "http server up (pid $HTTP_PID)"
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "stage 3: HTTP bench sweep"
  python -m zipvoice_torch.serving.client \
    --url "http://localhost:$port" \
    --prompt-wav "$prompt_wav" --prompt-text "$prompt_text" \
    --concurrency 1,2,4,8 --num-requests 16 --use-cache
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: gRPC server on :$grpc_port"
  python -m zipvoice_torch.serving.grpc_server \
    --model-dir "$model_dir" --model-name "$model_name" \
    --engine-dir "$engine_dir" --port "$grpc_port" \
    --num-step "$num_step" --guidance-scale "$guidance_scale" $qflag \
    --platform "$platform" &
  GRPC_PID=$!
  sleep 5
  log "grpc server up (pid $GRPC_PID)"
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  log "stage 5: gRPC bench (unary sweep + streaming TTFB)"
  python -m zipvoice_torch.serving.client_grpc \
    --target "localhost:$grpc_port" \
    --prompt-wav "$prompt_wav" --prompt-text "$prompt_text" \
    --concurrency 1,2,4,8 --n 16 --stream
fi
