#!/usr/bin/env bash
# Objective evaluation of ZipVoice-Dialog on the test-dialog benchmark:
# cpSIM (concatenated-permutation speaker similarity), WER, cpWER, UTMOS.
# Mirrors the reference egs/zipvoice_dialog/run_eval.sh stages 3-5.
#
# No network in this environment: point model paths at local copies
# (WavLM+ECAPA speaker model, whisper/paraformer ASR, UTMOS SSL weights)
# and test_dir at an on-disk copy of the test-dialog set.
set -euo pipefail

stage=${stage:-3}
stop_stage=${stop_stage:-5}
platform=${platform:-cuda}  # torch device of the models: cuda or cpu

model_dir=${model_dir:-download/zipvoice_dialog}
test_dir=${test_dir:-download/test-dialog}
res_dir=${res_dir:-results}
spk_model=${spk_model:-}
asr_model_en=${asr_model_en:-}
asr_model_zh=${asr_model_zh:-}
utmos_model=${utmos_model:-}

log() { echo "$(date '+%F %T') $*"; }

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  for lang in en zh; do
    log "stage 3: inference on test-dialog-$lang"
    python -m zipvoice_torch.bin.infer_zipvoice_dialog \
      --model-name zipvoice_dialog --model-dir "$model_dir" \
      --test-list "$test_dir/test_dialog_${lang}.tsv" \
      --res-dir "$res_dir/test_dialog_${lang}" \
      --platform "$platform"
  done
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  log "stage 4: evaluation on test-dialog-en"
  [ -n "$spk_model" ] && python -m zipvoice_torch.eval.cpsim_cli \
    --wav-dir "$res_dir/test_dialog_en" \
    --test-list "$test_dir/test_dialog_en.tsv" \
    --spk-model-path "$spk_model" --out "$res_dir/test_dialog_en/cpsim.txt" \
    --platform "$platform"
  [ -n "$asr_model_en" ] && python -m zipvoice_torch.eval.wer_cli \
    --wav-dir "$res_dir/test_dialog_en" \
    --test-list "$test_dir/test_dialog_en.tsv" --lang en --dialog \
    --asr-model-path "$asr_model_en" --out "$res_dir/test_dialog_en/wer.txt" \
    --platform "$platform"
  [ -n "$utmos_model" ] && python -m zipvoice_torch.eval.utmos_cli \
    --wav-dir "$res_dir/test_dialog_en" \
    --test-list "$test_dir/test_dialog_en.tsv" \
    --utmos-model-path "$utmos_model" \
    --out "$res_dir/test_dialog_en/utmos.txt" \
    --platform "$platform"
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  log "stage 5: evaluation on test-dialog-zh"
  [ -n "$spk_model" ] && python -m zipvoice_torch.eval.cpsim_cli \
    --wav-dir "$res_dir/test_dialog_zh" \
    --test-list "$test_dir/test_dialog_zh.tsv" \
    --spk-model-path "$spk_model" --out "$res_dir/test_dialog_zh/cpsim.txt" \
    --platform "$platform"
  [ -n "$asr_model_zh" ] && python -m zipvoice_torch.eval.wer_cli \
    --wav-dir "$res_dir/test_dialog_zh" \
    --test-list "$test_dir/test_dialog_zh.tsv" --lang zh --dialog \
    --asr-model-path "$asr_model_zh" --out "$res_dir/test_dialog_zh/wer.txt" \
    --platform "$platform"
  [ -n "$utmos_model" ] && python -m zipvoice_torch.eval.utmos_cli \
    --wav-dir "$res_dir/test_dialog_zh" \
    --test-list "$test_dir/test_dialog_zh.tsv" \
    --utmos-model-path "$utmos_model" \
    --out "$res_dir/test_dialog_zh/utmos.txt" \
    --platform "$platform"
fi
