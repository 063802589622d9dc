"""Precompute VocosFbank features for a manifest (counterpart of
``zipvoice_tpu/bin/compute_fbank.py``).

Replaces the reference's lhotse/lilcom feature store
(reference zipvoice/bin/compute_fbank.py) with per-utterance ``.fz`` files
(``data/featio.py``'s int16 codec) or raw ``.npy``, and rewrites the
manifest to point at them.  Host work only: the fbank runs with torch on
the CPU.

  python -m zipvoice_torch.bin.compute_fbank \\
    --manifest data/manifests/custom_cuts_train.jsonl.gz \\
    --output-dir data/fbank --num-jobs 8 [--num-channels 2]
"""

import argparse
import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--num-jobs", type=int, default=8)
    p.add_argument("--num-channels", type=int, default=1, choices=[1, 2])
    p.add_argument("--sampling-rate", type=int, default=24000)
    p.add_argument("--codec", type=str, default="fz", choices=["fz", "npy"],
                   help="fz = int16 codec (2x smaller, the lilcom role); "
                        "npy = raw float32")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.data.featio import save_feats
    from zipvoice_torch.data.manifest import read_manifest, write_manifest
    from zipvoice_torch.frontend.feature import VocosFbank

    cuts = read_manifest(args.manifest)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    extractor = VocosFbank(num_channels=args.num_channels)

    def process(cut):
        try:
            wav = cut.load_audio(args.sampling_rate)
            feats = extractor.extract(wav, args.sampling_rate)
            if args.codec == "fz":
                path = out / f"{cut.id}.fz"
                save_feats(str(path), feats.astype(np.float32))
            else:
                path = out / f"{cut.id}.npy"
                np.save(path, feats.astype(np.float32))
            cut.features = str(path)
            cut.num_frames = feats.shape[0]
            return cut
        except Exception as e:  # noqa: BLE001
            logging.warning(f"skipping {cut.id}: {e}")
            return None

    with ThreadPoolExecutor(args.num_jobs) as ex:
        done = [c for c in ex.map(process, cuts) if c is not None]

    if cuts and not done:
        raise RuntimeError(
            "feature extraction failed for every cut; manifest left untouched"
        )
    write_manifest(args.manifest, done)
    logging.info(f"computed features for {len(done)}/{len(cuts)} cuts")
    return len(done)


if __name__ == "__main__":
    main()
