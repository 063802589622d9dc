"""Prepare the OpenDialog corpus for ZipVoice-Dialog training.

Role of the reference egs/zipvoice_dialog/local/prepare_opendialog.py
(262 LoC, lhotse-based): read the corpus' per-language jsonl metadata —
one object per utterance with ``id``/``text``/``path`` fields — normalize
the text (``_`` is the pad symbol; collapse whitespace), resolve audio
paths, split a 1000-cut dev set off each language, and emit cut manifests.

We emit our jsonl.gz cut manifests directly (no lhotse).  Audio durations
are probed from the files when soundfile can read them (OpenDialog ships
mp3 — ffmpeg/soundfile with libsndfile>=1.1 handles it); otherwise pass
--skip-durations and run bin/prepare_dataset's probing later.

  python local/prepare_opendialog.py \
    --dataset-path download/OpenDialog --output-dir data/manifests
"""

import argparse
import json
import logging
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def probe_duration(path: Path):
    try:
        import soundfile as sf

        info = sf.info(str(path))
        return info.frames / info.samplerate
    except Exception as e:  # noqa: BLE001
        logging.debug(f"cannot probe {path}: {e}")
        return None


def clean_text(text: str) -> str:
    text = re.sub("_", " ", text)  # "_" is the pad symbol
    return re.sub(r"\s+", " ", text).strip()


def prepare_subset(jsonl_path: Path, lang: str, num_jobs: int,
                   dev_cuts: int, output_dir: Path,
                   skip_durations: bool) -> None:
    from zipvoice_torch.data.manifest import Cut, write_manifest

    entries = []
    with open(jsonl_path) as f:
        for line in f:
            try:
                item = json.loads(line)
                entries.append(
                    (item["id"], clean_text(item["text"]),
                     jsonl_path.parent / item["path"])
                )
            except Exception as e:  # noqa: BLE001
                logging.warning(f"bad metadata line ({e}): {line[:80]}")

    durations = {}
    if not skip_durations:
        with ThreadPoolExecutor(max_workers=num_jobs) as ex:
            futs = {
                ex.submit(probe_duration, p): p
                for p in {p for _, _, p in entries}
            }
            for fut, p in futs.items():
                d = fut.result()
                if d:
                    durations[p] = d

    cuts = []
    for uid, text, wav in entries:
        if not text:
            continue
        dur = durations.get(wav, 0.0)
        if not skip_durations and dur == 0.0:
            continue  # unreadable audio
        cuts.append(Cut(id=uid, wav=str(wav), text=text, duration=dur))

    dev = cuts[:dev_cuts]
    train = cuts[dev_cuts:]
    write_manifest(
        str(output_dir / f"opendialog_cuts_raw_{lang}-dev.jsonl.gz"), dev
    )
    write_manifest(
        str(output_dir / f"opendialog_cuts_raw_{lang}-train.jsonl.gz"), train
    )
    logging.info(
        f"{lang}: {len(train)} train / {len(dev)} dev cuts "
        f"({sum(c.duration for c in cuts) / 3600:.1f} h)"
    )


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset-path", type=str, required=True,
                   help="OpenDialog root (metadata jsonl per language)")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--num-jobs", type=int, default=8)
    p.add_argument("--dev-cuts", type=int, default=1000,
                   help="cuts reserved for the dev split per language")
    p.add_argument("--skip-durations", action="store_true",
                   help="emit manifests without probing audio durations")
    args = p.parse_args()

    logging.basicConfig(level=logging.INFO)
    root = Path(args.dataset_path)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    found = False
    for lang in ("EN", "ZH"):
        for cand in (root / f"{lang.lower()}.jsonl",
                     root / "metadata" / f"{lang.lower()}.jsonl",
                     root / f"meta_{lang.lower()}.jsonl"):
            if cand.exists():
                prepare_subset(cand, lang, args.num_jobs, args.dev_cuts,
                               out, args.skip_durations)
                found = True
                break
        else:
            logging.warning(f"no metadata jsonl found for {lang}")
    if not found:
        raise SystemExit(
            f"no OpenDialog metadata found under {root}; expected "
            "en.jsonl/zh.jsonl (or metadata/<lang>.jsonl)"
        )


if __name__ == "__main__":
    main()
