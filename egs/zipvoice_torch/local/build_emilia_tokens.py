"""Build the Emilia phone vocabulary (pinyin initials/finals + espeak IPA).

The reference ships a fixed emilia token file (pinyin table + espeak phone
inventory, egs/zipvoice/local).  This builder generates the deterministic
parts — pad, punctuation, the full pinyin initial('0')/final(tone 1-5)
inventory from standard pinyin phonology (matching
frontend/tokenizer.split_pinyin's output space) — and appends the espeak
IPA phones observed in a tokenized manifest (run bin/prepare_tokens first;
requires libespeak-ng for real IPA output).

  python egs/zipvoice_torch/local/build_emilia_tokens.py \
    --output data/tokens_emilia.txt \
    [--manifest data/manifests/emilia_cuts_train.jsonl.gz]
"""

import argparse

INITIALS = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "zh", "ch", "sh", "r", "z", "c", "s", "y", "w",
]

# standard pinyin finals (non-strict/tone3 style, as produced by
# frontend/tokenizer.split_pinyin for pypinyin-compatible syllables)
FINALS = [
    "a", "o", "e", "i", "u", "v", "ai", "ei", "ui", "ao", "ou", "iu",
    "ie", "ve", "er", "an", "en", "in", "un", "vn", "ang", "eng", "ing",
    "ong", "ia", "iao", "ian", "iang", "iong", "ua", "uo", "uai", "uan",
    "uang", "ueng", "van", "ue", "uen", "ng", "n", "m",
]

PUNCT = list(",.!?;:'\"-…()") + [" "]


def espeak_ipa_inventory():
    """The espeak IPA codepoint inventory (piper get_espeak_map tokens),
    shipped statically so English phoneme tokens always have ids even when
    no tokenized manifest is given (reference builds this from
    piper_phonemize.get_espeak_map(), egs/zipvoice_torch/local/
    prepare_token_file_emilia.py:72-75)."""
    from zipvoice_torch.frontend.en_g2p import ESPEAK_IPA_CODEPOINTS

    return list(ESPEAK_IPA_CODEPOINTS)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--manifest", type=str, action="append", default=None,
                   help="tokenized manifests contributing espeak phones")
    p.add_argument("--extra-tokens", type=str, default=None)
    args = p.parse_args()

    tokens = ["_"]
    tokens += PUNCT
    tokens += espeak_ipa_inventory()
    tokens += [i + "0" for i in INITIALS]
    tokens += [f + str(t) for f in FINALS for t in range(1, 6)]

    if args.manifest:
        from zipvoice_torch.data.manifest import iter_manifest

        seen = set(tokens)
        extra = set()
        for m in args.manifest:
            for cut in iter_manifest(m):
                for t in cut.tokens or []:
                    if t not in seen:
                        extra.add(t)
        tokens += sorted(extra)

    if args.extra_tokens:
        for t in args.extra_tokens.split(","):
            if t and t not in tokens:
                tokens.append(t)

    with open(args.output, "w", encoding="utf-8") as f:
        for i, t in enumerate(tokens):
            f.write(f"{t}\t{i}\n")
    print(f"wrote {len(tokens)} tokens to {args.output}")


if __name__ == "__main__":
    main()
