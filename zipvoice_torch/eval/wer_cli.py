"""WER evaluation driver (the port's counterpart of
``zipvoice_tpu/eval/wer_cli.py``; reference
zipvoice/eval/wer/{seedtts,hubert,dialog}.py).

Transcribes generated wavs with a local ASR model and scores WER against
the reference transcripts, with the reference's exact pre-scoring text
normalization (strip CJK+ASCII punctuation except apostrophes, lowercase
en / char-split zh — seedtts.py:128-151).

Backends (selected by --backend, default auto):
- ``whisper``:   WhisperForConditionalGeneration with forced
                 language+transcribe decoder ids — the reference's English
                 scorer (seedtts.py:96-110,220-233);
- ``paraformer``: funasr AutoModel — the reference's Chinese scorer
                 (seedtts.py:112-124,235-240); requires funasr installed.
                 Traditional->simplified conversion applies when zhconv is
                 importable (seedtts.py:238);
- ``pipeline``:  generic HF ASR pipeline — the reference's hubert CTC path
                 (hubert.py:70) and the fallback when funasr is absent.

Model weights must be local (the driver fetches nothing): pass --model-dir
containing the reference layout (wer/whisper-large-v3/, wer/paraformer-zh/)
or point --asr-model-path at any model directory.  Every backend runs on
``--platform`` (CUDA unless ``cpu`` is asked for).

  python -m zipvoice_torch.eval.wer_cli \\
    --wav-dir results --test-list test.tsv --lang en \\
    --model-dir /models/tts_eval_models
"""

import argparse
import logging
import os

import torch


def _auto_backend(lang: str, model_path: str) -> str:
    name = os.path.basename(os.path.normpath(model_path)).lower()
    if lang == "zh" or "paraformer" in name:
        try:
            import funasr  # noqa: F401

            return "paraformer"
        except ImportError:
            logging.warning(
                "funasr not installed; falling back to the HF pipeline for "
                "zh (WERs may not be comparable to the reference's "
                "Paraformer scores)"
            )
            return "pipeline"
    if "whisper" in name:
        return "whisper"
    return "pipeline"


def _resolve_model_path(args) -> str:
    if args.asr_model_path:
        return args.asr_model_path
    assert args.model_dir, "pass --model-dir or --asr-model-path"
    sub = "wer/whisper-large-v3" if args.lang == "en" else "wer/paraformer-zh"
    path = os.path.join(args.model_dir, sub)
    assert os.path.exists(path), (
        f"{path} not found (reference layout of k2-fsa/TTS_eval_models)"
    )
    return path


def transcribe_whisper(model_path: str, wav_paths, lang: str,
                       device="cuda"):
    """The reference's English decode (seedtts.py:220-233)."""
    from transformers import WhisperForConditionalGeneration, WhisperProcessor

    from zipvoice_torch.frontend.audio import load_wav

    processor = WhisperProcessor.from_pretrained(model_path)
    model = WhisperForConditionalGeneration.from_pretrained(model_path)
    model.to(device).eval()
    language = "english" if lang == "en" else "chinese"
    # The reference passes forced_decoder_ids to generate (seedtts.py:220),
    # an API transformers removed in 4.5x.  Force the same
    # language+transcribe prompt through the supported surface: the
    # language/task kwargs when the checkpoint's generation_config carries
    # the token maps (whisper-large-v3 does), else an explicit decoder
    # prompt built from the same get_decoder_prompt_ids ids.
    gen_kwargs = {}
    if getattr(model.generation_config, "lang_to_id", None):
        gen_kwargs = {"language": language, "task": "transcribe"}
    else:
        forced = processor.get_decoder_prompt_ids(
            language=language, task="transcribe"
        )
        prompt = [model.config.decoder_start_token_id]
        prompt += [tok for _, tok in forced]
        gen_kwargs = {
            "decoder_input_ids": torch.tensor([prompt], device=device)
        }
    outputs = []
    for p in wav_paths:
        wav = load_wav(p, 16000)[0]
        feats = processor(
            wav, sampling_rate=16000, return_tensors="pt"
        ).input_features.to(device)
        with torch.no_grad():
            ids = model.generate(feats, **gen_kwargs)
        outputs.append(
            processor.batch_decode(ids, skip_special_tokens=True)[0]
        )
    return outputs


def transcribe_paraformer(model_path: str, wav_paths, lang: str,
                          device="cuda"):
    """The reference's Chinese decode (seedtts.py:235-240): funasr
    Paraformer + traditional->simplified conversion."""
    from funasr import AutoModel

    model = AutoModel(model=model_path, disable_update=True,
                      device=str(device))
    try:
        import zhconv
    except ImportError:
        zhconv = None
        logging.warning("zhconv not installed; skipping zh-cn conversion")
    outputs = []
    for p in wav_paths:
        res = model.generate(input=p)
        text = res[0]["text"] if res else ""
        if zhconv is not None:
            text = zhconv.convert(text, "zh-cn")
        outputs.append(text)
    return outputs


def transcribe_pipeline(model_path: str, wav_paths, lang: str,
                        device="cuda"):
    """Generic HF pipeline (the reference's hubert CTC driver,
    hubert.py:70)."""
    from transformers import pipeline

    from zipvoice_torch.frontend.audio import load_wav

    asr = pipeline(
        "automatic-speech-recognition", model=model_path,
        device=torch.device(device),
    )
    outputs = []
    for p in wav_paths:
        wav = load_wav(p, 16000)[0]
        out = asr({"raw": wav, "sampling_rate": 16000})
        outputs.append(out["text"])
    return outputs


TRANSCRIBERS = {
    "whisper": transcribe_whisper,
    "paraformer": transcribe_paraformer,
    "pipeline": transcribe_pipeline,
}


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-dir", type=str, required=True)
    p.add_argument("--test-list", type=str, required=True,
                   help="tsv: name\\tprompt_text\\tprompt_wav\\ttext")
    p.add_argument("--lang", type=str, default="en", choices=["en", "zh"])
    p.add_argument("--model-dir", type=str, default=None,
                   help="root of the reference's tts_eval_models layout")
    p.add_argument("--asr-model-path", type=str, default=None,
                   help="explicit ASR model directory (overrides "
                        "--model-dir)")
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "whisper", "paraformer", "pipeline"])
    p.add_argument("--dialog", action="store_true",
                   help="score cpWER as well ([S1]/[S2] transcripts)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--platform", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="torch device of the ASR model; without CUDA the "
                        "driver fails unless --platform cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.eval.metrics import (
        corpus_wer,
        cpwer,
        post_process,
        wer,
    )
    from zipvoice_torch.utils.device import resolve_device

    device = resolve_device(args.platform)
    model_path = _resolve_model_path(args)
    backend = (
        _auto_backend(args.lang, model_path)
        if args.backend == "auto" else args.backend
    )
    logging.info(f"ASR backend: {backend} ({model_path}) on {device}")

    names, refs = [], []
    with open(args.test_list) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            names.append(parts[0])
            refs.append(parts[-1])

    wav_paths = [os.path.join(args.wav_dir, n + ".wav") for n in names]
    missing = [p for p in wav_paths if not os.path.exists(p)]
    assert not missing, f"missing wavs: {missing[:5]}..."

    hyps = TRANSCRIBERS[backend](model_path, wav_paths, args.lang, device)

    overall = corpus_wer(list(zip(refs, hyps)), args.lang)
    lines = [f"overall WER: {overall * 100:.2f}%"]
    for n, r, h in zip(names, refs, hyps):
        d = wer(r, h, args.lang)
        line = (
            f"{n}\t{d['wer'] * 100:.2f}\t"
            f"{post_process(h, args.lang)}"
        )
        if args.dialog:
            line += f"\tcpwer={cpwer(r, h, args.lang) * 100:.2f}"
        lines.append(line)
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")


if __name__ == "__main__":
    main()
