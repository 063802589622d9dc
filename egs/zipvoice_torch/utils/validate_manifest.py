"""Validate a cut manifest for TTS training.

Role of the reference's egs/zipvoice_torch/utils/validate_manifest.py (which wraps
lhotse's validate_for_tts): every cut must have exactly one supervision whose
span lies inside the cut, non-empty text, positive duration within sane
bounds, and a readable audio path (or precomputed features).

  python egs/zipvoice_torch/utils/validate_manifest.py data/manifests/custom_cuts_train.jsonl.gz
"""

import argparse
import os
import sys


def validate(manifest_path: str, check_files: bool = True) -> int:
    from zipvoice_torch.data.manifest import read_manifest

    cuts = read_manifest(manifest_path)
    errors = 0

    def err(cut_id, msg):
        nonlocal errors
        errors += 1
        print(f"ERROR [{cut_id}]: {msg}", file=sys.stderr)

    seen = set()
    for c in cuts:
        if c.id in seen:
            err(c.id, "duplicate cut id")
        seen.add(c.id)
        if not (c.text and c.text.strip()):
            err(c.id, "empty supervision text")
        if not (0 < c.duration <= 120.0):
            err(c.id, f"suspicious duration {c.duration:.2f}s")
        if c.end is not None and c.end - c.start <= 0:
            err(c.id, f"empty span [{c.start}, {c.end}]")
        if not c.wav and not c.features:
            err(c.id, "neither audio path nor features present")
        if check_files:
            for p in filter(None, [c.wav, c.features]):
                if not os.path.exists(p):
                    err(c.id, f"missing file {p}")
    print(f"{manifest_path}: {len(cuts)} cuts, {errors} errors")
    return errors


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("manifests", nargs="+")
    p.add_argument("--no-check-files", action="store_true",
                   help="skip filesystem existence checks")
    args = p.parse_args()
    total = sum(
        validate(m, check_files=not args.no_check_files)
        for m in args.manifests
    )
    sys.exit(1 if total else 0)


if __name__ == "__main__":
    main()
