"""Preprocess Emilia corpus metadata into training TSVs.

Mirrors the reference's egs/zipvoice/local Emilia preprocessing: reads the
corpus' jsonl metadata (one object per utterance with wav/text/language/
dnsmos fields), keeps zh/en, applies quality filtering, and writes the
``id\ttext\twav`` TSVs consumed by bin/prepare_dataset.

  python egs/zipvoice_torch/local/preprocess_emilia.py \
    --jsonl EmiliaDataset/meta/*.jsonl --wav-root EmiliaDataset \
    --output-dir data/raw [--min-dnsmos 3.0]
"""

import argparse
import glob
import json
import os


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--jsonl", type=str, nargs="+", required=True)
    p.add_argument("--wav-root", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--languages", type=str, default="zh,en")
    p.add_argument("--min-dnsmos", type=float, default=3.0)
    p.add_argument("--dev-utts", type=int, default=512,
                   help="utterances per language reserved for the dev split")
    args = p.parse_args()

    langs = set(args.languages.split(","))
    os.makedirs(args.output_dir, exist_ok=True)
    writers = {
        (lang, subset): open(
            os.path.join(args.output_dir, f"emilia_{lang}_{subset}.tsv"),
            "w", encoding="utf-8",
        )
        for lang in langs
        for subset in ("train", "dev")
    }
    kept = dropped = 0
    per_lang_count = {lang: 0 for lang in langs}
    paths = [q for pat in args.jsonl for q in sorted(glob.glob(pat))]
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                lang = rec.get("language", rec.get("lang"))
                if lang not in langs:
                    dropped += 1
                    continue
                if rec.get("dnsmos", 10.0) < args.min_dnsmos:
                    dropped += 1
                    continue
                wav = rec.get("wav", rec.get("audio"))
                text = (rec.get("text") or "").strip().replace("\t", " ")
                uid = rec.get("id") or os.path.splitext(
                    os.path.basename(wav)
                )[0]
                if not wav or not text:
                    dropped += 1
                    continue
                wav = os.path.join(args.wav_root, wav)
                subset = (
                    "dev" if per_lang_count[lang] < args.dev_utts else "train"
                )
                per_lang_count[lang] += 1
                writers[(lang, subset)].write(f"{uid}\t{text}\t{wav}\n")
                kept += 1
    for w in writers.values():
        w.close()
    names = sorted(f"emilia_{lg}_{sub}" for lg, sub in writers)
    print(f"kept {kept}, dropped {dropped}; wrote "
          f"{', '.join(names)} TSVs to {args.output_dir}")


if __name__ == "__main__":
    main()
