"""Prepare a dataset manifest from a TSV file (counterpart of
``zipvoice_tpu/bin/prepare_dataset.py``).

TSV format (reference zipvoice/bin/prepare_dataset.py:169-258):
  id\ttext\twav[\tstart\tend]

Writes a jsonl manifest with durations (read from the wav headers; no
resampling here, the dataset resamples to 24 kHz on read).  Host work only.

  python -m zipvoice_torch.bin.prepare_dataset \\
    --tsv-path data/raw/train.tsv --prefix custom --subset train \\
    --num-jobs 8 --output-dir data/manifests
"""

import argparse
import logging
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def wav_duration(path: str) -> float:
    try:
        import soundfile as sf

        info = sf.info(path)
        return info.frames / info.samplerate
    except ImportError:
        with wave.open(path, "rb") as f:
            return f.getnframes() / f.getframerate()


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tsv-path", type=str, required=True)
    p.add_argument("--prefix", type=str, default="custom")
    p.add_argument("--subset", type=str, default="train")
    p.add_argument("--num-jobs", type=int, default=8)
    p.add_argument("--output-dir", type=str, required=True)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.data.manifest import Cut, write_manifest

    rows = []
    with open(args.tsv_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            rows.append(parts)

    def build(parts):
        uid, text, wav = parts[0], parts[1], parts[2]
        start = float(parts[3]) if len(parts) > 3 else 0.0
        end = float(parts[4]) if len(parts) > 4 else None
        try:
            dur = (end - start) if end is not None \
                else wav_duration(wav) - start
        except Exception as e:  # noqa: BLE001
            logging.warning(f"skipping {uid}: {e}")
            return None
        return Cut(id=uid, wav=wav, text=text, duration=dur, start=start,
                   end=end)

    with ThreadPoolExecutor(args.num_jobs) as ex:
        cuts = [c for c in ex.map(build, rows) if c is not None]

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{args.prefix}_cuts_{args.subset}.jsonl.gz"
    write_manifest(str(path), cuts)
    logging.info(f"wrote {len(cuts)} cuts to {path}")
    return str(path)


if __name__ == "__main__":
    main()
