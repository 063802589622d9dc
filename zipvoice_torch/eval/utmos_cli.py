"""UTMOS naturalness MOS prediction driver (the port's counterpart of
``zipvoice_tpu/eval/utmos_cli.py``).

Reference: zipvoice/eval/mos/utmos.py (UTMOS22Strong reimplementation over a
wav2vec2 SSL backbone).  Pass --utmos-model-path with either a TorchScript
export or a state dict of ``zipvoice_torch.eval.utmos_model.UTMOS22Strong``
(the released checkpoint's keys); the driver fetches nothing.  The model
runs on ``--platform`` (CUDA unless ``cpu`` is asked for).

  python -m zipvoice_torch.eval.utmos_cli --wav-dir results \\
    --test-list test.tsv --utmos-model-path /models/utmos22_strong.pt
"""

import argparse
import logging
import os

import numpy as np
import torch


def load_utmos(path: str, device) -> torch.nn.Module:
    """A TorchScript export at ``path``, or else ``UTMOS22Strong`` with the
    state dict there (bare or under "model"), on ``device``, in eval
    mode."""
    try:
        model = torch.jit.load(path, map_location=device)
    except Exception:
        from zipvoice_torch.eval.utmos_model import UTMOS22Strong

        sd = torch.load(path, map_location="cpu")
        if "model" in sd:
            sd = sd["model"]
        # built without storage: the file's tensors become the parameters
        with torch.device("meta"):
            model = UTMOS22Strong()
        model.load_state_dict(sd, assign=True)
        model.to(device)
    return model.eval()


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-dir", type=str, required=True)
    p.add_argument("--test-list", type=str, required=True)
    p.add_argument("--utmos-model-path", type=str, required=True)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--platform", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="torch device of the model; without CUDA the "
                        "driver fails unless --platform cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.frontend.audio import load_wav
    from zipvoice_torch.utils.device import resolve_device

    device = resolve_device(args.platform)
    model = load_utmos(args.utmos_model_path, device)

    names = []
    with open(args.test_list) as f:
        for line in f:
            names.append(line.rstrip("\n").split("\t")[0])

    scores = []
    with torch.no_grad():
        for n in names:
            wav = load_wav(os.path.join(args.wav_dir, n + ".wav"), 16000)
            score = model(torch.from_numpy(wav).to(device),
                          torch.tensor([16000]))
            scores.append(float(score))

    report = [f"overall UTMOS: {np.mean(scores):.4f}"]
    report += [f"{n}\t{s:.4f}" for n, s in zip(names, scores)]
    print("\n".join(report))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(report) + "\n")


if __name__ == "__main__":
    main()
