"""Build a tokens.txt vocabulary from tokenized manifests (counterpart of
``zipvoice_tpu/bin/build_tokens.py``).  Host only: it touches no device.

Collects the token inventory of the manifests (run ``bin/prepare_tokens``
first) and writes ``{token}\\t{id}`` lines with '_' (pad) as id 0, the
reference's file format (tokenizer.py:83-90).

  python -m zipvoice_torch.bin.build_tokens \\
    --manifest data/manifests/custom_cuts_train.jsonl.gz \\
    --output data/tokens.txt [--extra-tokens "[S1],[S2]"]
"""

import argparse
import logging


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", type=str, action="append", required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--extra-tokens", type=str, default=None,
                   help="comma-separated tokens appended at the end "
                        "(e.g. '[S1],[S2]' for dialog)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.data.manifest import iter_manifest

    inventory = set()
    for m in args.manifest:
        for cut in iter_manifest(m):
            if cut.tokens is None:
                raise ValueError(f"{cut.id} has no tokens; run "
                                 "bin/prepare_tokens first")
            inventory.update(cut.tokens)

    tokens = ["_"] + sorted(inventory - {"_"})
    if args.extra_tokens:
        for t in args.extra_tokens.split(","):
            if t and t not in tokens:
                tokens.append(t)

    with open(args.output, "w", encoding="utf-8") as f:
        for i, t in enumerate(tokens):
            f.write(f"{t}\t{i}\n")
    logging.info(f"wrote {len(tokens)} tokens to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
