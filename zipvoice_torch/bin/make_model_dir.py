"""Write a reference-layout model dir with RANDOM weights (counterpart of
``tools/make_bench_model_dir.py``): ``model.pt``, ``model.json`` and
``tokens.txt`` with the Emilia vocabulary, loadable by
``utils/checkpoint_io.load_model_dir`` and ``bin/infer_zipvoice`` (or, for
the dialog models, ``bin/infer_zipvoice_dialog``), and optionally a random
Vocos ``pytorch_model.bin`` in the published key layout.  Latency does not
depend on the weights, and nothing is downloaded.

  python -m zipvoice_torch.bin.make_model_dir --out /tmp/zipvoice_random \
      [--model-name zipvoice_distill|zipvoice_dialog|zipvoice_dialog_stereo] \
      [--vocoder] [--tiny] [--seed 0]

The dialog models' vocabulary is the Emilia one with [S1] and [S2]
appended.

``--tiny`` writes a narrow model (one layer a stack, dim 48) and, with
``--vocoder``, a narrow Vocos, both at the published 100 mel bins: a dir
the CLI runs through on the CPU in seconds.
"""

import argparse
import json
import os
import sys
from typing import List, Optional

import torch

from zipvoice_torch.frontend.en_g2p import ESPEAK_IPA_CODEPOINTS
from zipvoice_torch.models.zipvoice import build_zipvoice
from zipvoice_torch.utils.checkpoint_io import DIALOG_MODELS, MODEL_CLASSES
from zipvoice_torch.vocoder.vocos import build_vocos

# the ZipVoice base model's published config
BASE_CONFIG = dict(
    fm_decoder_downsampling_factor=[1, 2, 4, 2, 1],
    fm_decoder_num_layers=[2, 2, 4, 4, 4],
    fm_decoder_cnn_module_kernel=[31, 15, 7, 15, 31],
    fm_decoder_feedforward_dim=1536,
    fm_decoder_num_heads=4,
    fm_decoder_dim=512,
    text_encoder_num_layers=4,
    text_encoder_feedforward_dim=512,
    text_encoder_cnn_module_kernel=9,
    text_encoder_num_heads=4,
    text_encoder_dim=192,
    time_embed_dim=192,
    text_embed_dim=192,
    query_head_dim=32,
    value_head_dim=12,
    pos_head_dim=4,
    pos_dim=48,
    feat_dim=100,
)
TINY_CONFIG = dict(
    BASE_CONFIG,
    fm_decoder_num_layers=[1, 1, 1, 1, 1],
    fm_decoder_cnn_module_kernel=[7, 5, 3, 5, 7],
    fm_decoder_feedforward_dim=64,
    fm_decoder_dim=48,
    text_encoder_num_layers=1,
    text_encoder_feedforward_dim=48,
    text_encoder_cnn_module_kernel=5,
    text_encoder_dim=32,
    time_embed_dim=32,
    text_embed_dim=32,
    query_head_dim=8,
)
TINY_VOCOS = dict(n_mels=100, dim=32, intermediate_dim=48, num_layers=2)

# the Emilia phone vocabulary: pad, punctuation, the espeak IPA inventory,
# pinyin initials (with a trailing '0') and finals with tones 1-5, in the
# order of the JAX package's egs/zipvoice/local/build_emilia_tokens.py
PUNCT = list(",.!?;:'\"-…()") + [" "]
INITIALS = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "zh", "ch", "sh", "r", "z", "c", "s", "y", "w",
]
FINALS = [
    "a", "o", "e", "i", "u", "v", "ai", "ei", "ui", "ao", "ou", "iu",
    "ie", "ve", "er", "an", "en", "in", "un", "vn", "ang", "eng", "ing",
    "ong", "ia", "iao", "ian", "iang", "iong", "ua", "uo", "uai", "uan",
    "uang", "ueng", "van", "ue", "uen", "ng", "n", "m",
]


def emilia_tokens() -> List[str]:
    tokens = ["_"] + PUNCT + list(ESPEAK_IPA_CODEPOINTS)
    tokens += [i + "0" for i in INITIALS]
    tokens += [f + str(t) for f in FINALS for t in range(1, 6)]
    return tokens


def make_model_dir(out: str, model_name: str = "zipvoice",
                   config: dict = BASE_CONFIG, seed: int = 0,
                   vocos_config: Optional[dict] = None) -> None:
    """Write ``out``/{model.pt, model.json, tokens.txt} with weights drawn
    from ``seed``, and ``out``/pytorch_model.bin (a Vocos with
    ``vocos_config``'s widths, from ``seed + 1``) unless ``vocos_config``
    is None."""
    os.makedirs(out, exist_ok=True)
    tokens = emilia_tokens()
    extra = {}
    if model_name in DIALOG_MODELS:
        extra = dict(spk_a_id=len(tokens), spk_b_id=len(tokens) + 1)
        tokens += ["[S1]", "[S2]"]
    with open(os.path.join(out, "tokens.txt"), "w", encoding="utf-8") as f:
        for i, t in enumerate(tokens):
            f.write(f"{t}\t{i}\n")
    with open(os.path.join(out, "model.json"), "w") as f:
        json.dump({"model": config}, f, indent=2)

    model = build_zipvoice(model_class=MODEL_CLASSES[model_name],
                           device="cpu", seed=seed, vocab_size=len(tokens),
                           pad_id=0, **config, **extra)
    torch.save({"model": model.state_dict()}, os.path.join(out, "model.pt"))
    if vocos_config is not None:
        vocos = build_vocos(device="cpu", seed=seed + 1, **vocos_config)
        torch.save(vocos.state_dict(),
                   os.path.join(out, "pytorch_model.bin"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    ap.add_argument("--out", required=True)
    ap.add_argument("--model-name", default="zipvoice",
                    choices=sorted(MODEL_CLASSES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocoder", action="store_true",
                    help="also write a random Vocos pytorch_model.bin")
    ap.add_argument("--tiny", action="store_true",
                    help="narrow widths, for runs on the CPU")
    args = ap.parse_args(argv)
    vocos_config = None
    if args.vocoder:
        vocos_config = TINY_VOCOS if args.tiny else {}
    make_model_dir(args.out, args.model_name,
                   TINY_CONFIG if args.tiny else BASE_CONFIG, args.seed,
                   vocos_config)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
