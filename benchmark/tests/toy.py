"""A toy checkout for the benchmark's CPU tests: the repository's
benchmark folder and ``BENCHMARK.json``, with two toy cells, their
configuration and traffic mixes, and a toy per-layer metric added as new
files and entries only, at widths a CPU runs in seconds."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TOY_MODEL = dict(
    fm_decoder_downsampling_factor=[1, 2, 4, 2, 1],
    fm_decoder_num_layers=[1, 1, 1, 1, 1],
    fm_decoder_cnn_module_kernel=[7, 5, 3, 5, 7],
    fm_decoder_feedforward_dim=64, fm_decoder_num_heads=4, fm_decoder_dim=48,
    text_encoder_num_layers=1, text_encoder_feedforward_dim=48,
    text_encoder_cnn_module_kernel=5, text_encoder_num_heads=4,
    text_encoder_dim=32, time_embed_dim=32, text_embed_dim=32,
    query_head_dim=8, value_head_dim=12, pos_head_dim=4, pos_dim=48,
    feat_dim=100, vocab_size=360, pad_id=0)
TOY_VOCOS = dict(n_mels=100, dim=32, intermediate_dim=48, num_layers=2,
                 n_fft=1024, hop_length=256)
PROMPTS = {"sentences": [15, 58], "tokens_per_s": 14.0,
           "edge_silence_s": 0.3}
TOY_METRIC = '''"""Sample calls in the window's unprofiled part (a toy)."""


def read(rec):
    calls = rec.get("sample_calls")
    return len(calls) if calls else None
'''


def make(tmp: str) -> str:
    """Write the toy checkout under ``tmp``; returns its root.  Its cells
    compare at the limits of ``zipvoice.longform``, so that a planted fault
    is held to what the real cell would let pass."""
    root = os.path.join(tmp, "checkout")
    with open(os.path.join(REPO, "benchmark", "traffic",
                           "longform.json")) as f:
        limits = json.load(f)["check"]["limits"]
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, "zipvoice_torch"),
               os.path.join(root, "zipvoice_torch"))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(bench, "configs", "zipvoice.json")) as f:
        base = json.load(f)
    toy = dict(base, model=TOY_MODEL, vocoder=TOY_VOCOS, dtype="float32",
               inference=dict(base["inference"], num_step=2))
    files = {
        "configs/toy_zipvoice.json": toy,
        "traffic/toy_longform.json": {
            "driver": "offline",
            "passages": {"spans": [[0, 1], [13, 1], [26, 2]], "prompts": 2},
            "prompts": PROMPTS, "max_duration": 100.0,
            "speed": 1.0, "trace_slice_s": 1.0,
            "check": {"calls": 2, "limits": limits}},
        "traffic/toy_longform_multi.json": {
            "driver": "offline",
            "passages": {"spans": [[0, 6]], "prompts": 1},
            "prompts": PROMPTS, "max_duration": 100.0,
            "speed": 1.0, "trace_slice_s": 1.0,
            "check": {"calls": 1, "limits": limits}},
    }
    for name, obj in files.items():
        with open(os.path.join(bench, name), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(bench, "metrics", "toy_calls.py"), "w") as f:
        f.write(TOY_METRIC)
    spec["configs"] += [
        {"name": "toy_zipvoice",
         "source": "https://github.com/k2-fsa/ZipVoice",
         "file": "benchmark/configs/toy_zipvoice.json", "reduced": [],
         "why": "toy"}]
    spec["workloads"] += [
        {"name": "toy.longform", "config": "toy_zipvoice",
         "traffic": "toy_longform", "chips": 1, "why": "toy"},
        {"name": "toy.longform_multi", "config": "toy_zipvoice",
         "traffic": "toy_longform_multi", "chips": 1,
         "why": "toy: one passage in two chunks, a batch of two rows"}]
    spec["per_layer"].append(
        {"name": "toy_calls", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "toy", "moves": "audio_s_per_s",
         "workloads": ["toy.longform", "toy.longform_multi"]})
    for m in spec["per_layer"]:
        if m["name"] in ("pad_share", "mfu", "idle_share"):
            m["workloads"] = m["workloads"] + ["toy.longform",
                                               "toy.longform_multi"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root
