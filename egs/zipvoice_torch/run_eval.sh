#!/usr/bin/env bash
# Objective evaluation of generated speech: WER, speaker SIM, UTMOS.
# Mirrors the reference egs/zipvoice/run_eval.sh stages 3-6.
# Local model paths are required (no network): set asr_model/spk_model/utmos_model.
set -euo pipefail

stage=${stage:-1}
stop_stage=${stop_stage:-3}
platform=${platform:-cuda}  # torch device of the models: cuda or cpu

wav_dir=${wav_dir:-results}
test_list=${test_list:-test.tsv}
lang=${lang:-en}
asr_model=${asr_model:-}
spk_model=${spk_model:-}
utmos_model=${utmos_model:-}

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ] && [ -n "$asr_model" ]; then
  python -m zipvoice_torch.eval.wer_cli \
    --wav-dir "$wav_dir" --test-list "$test_list" --lang "$lang" \
    --asr-model-path "$asr_model" --out "$wav_dir/wer.txt" \
    --platform "$platform"
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ] && [ -n "$spk_model" ]; then
  python -m zipvoice_torch.eval.sim_cli \
    --wav-dir "$wav_dir" --test-list "$test_list" \
    --spk-model-path "$spk_model" --out "$wav_dir/sim.txt" \
    --platform "$platform"
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ] && [ -n "$utmos_model" ]; then
  python -m zipvoice_torch.eval.utmos_cli \
    --wav-dir "$wav_dir" --test-list "$test_list" \
    --utmos-model-path "$utmos_model" --out "$wav_dir/utmos.txt" \
    --platform "$platform"
fi
