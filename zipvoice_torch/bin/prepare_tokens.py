"""Tokenize manifest texts offline, caching the string tokens in the
manifest (counterpart of ``zipvoice_tpu/bin/prepare_tokens.py``; reference
zipvoice/bin/prepare_tokens.py).  Host only: it touches no device.

  python -m zipvoice_torch.bin.prepare_tokens \\
    --manifest data/manifests/custom_cuts_train.jsonl.gz \\
    --tokenizer emilia [--lang en-us]
"""

import argparse
import logging


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--tokenizer", type=str, default="emilia")
    p.add_argument("--lang", type=str, default="en-us")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.data.manifest import read_manifest, write_manifest
    from zipvoice_torch.frontend.tokenizer import get_tokenizer

    tokenizer = get_tokenizer(args.tokenizer, None, args.lang)
    cuts = read_manifest(args.manifest)
    tokens = tokenizer.texts_to_tokens([c.text for c in cuts])
    for c, t in zip(cuts, tokens):
        c.tokens = t
    write_manifest(args.manifest, cuts)
    logging.info(f"tokenized {len(cuts)} cuts")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
