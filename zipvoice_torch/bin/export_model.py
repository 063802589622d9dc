"""Export the sampling programs (engines) of a model dir (counterpart of
``zipvoice_tpu/bin/export_model.py``): ``torch.export`` programs per shape
bucket, without the weights, which ``bin/infer_exported`` and the server's
``--engine-dir`` replay as CUDA graphs on the card (``serving/aot.py``).

  python -m zipvoice_torch.bin.export_model --model-dir DIR --out-dir eng \\
    [--buckets "1:128:1024,4:128:1280"] [--num-step 16] [--guidance-scale 1]

Differences from the JAX CLI:
- ``--platform cuda|cpu`` picks the device the programs are traced on,
  and run on, and defaults to ``cuda``;
- ``--bf16`` chooses the dtype the programs are traced in; the manifest
  records it, and a model that differs is refused when the engines are
  loaded.
"""

import argparse
import logging


def get_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--model-name", type=str, default="zipvoice",
                   choices=["zipvoice", "zipvoice_distill"])
    p.add_argument("--out-dir", type=str, required=True)
    p.add_argument("--buckets", type=str, default="1:128:1024",
                   help="comma list of B:S:T shape buckets")
    p.add_argument("--num-step", type=int, default=16)
    p.add_argument("--guidance-scale", type=float, default=1.0)
    p.add_argument("--t-shift", type=float, default=0.5)
    p.add_argument("--platform", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (f32 norms), as the server runs")
    return p


def parse_buckets(spec: str):
    """"B:S:T,..." -> [(B, S, T), ...]."""
    return [tuple(int(x) for x in b.strip().split(":"))
            for b in spec.split(",")]


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from zipvoice_torch.serving.aot import export_sample_program
    from zipvoice_torch.utils.checkpoint_io import load_model_dir
    from zipvoice_torch.utils.device import resolve_device

    device = resolve_device(args.platform)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, _ = load_model_dir(args.model_dir, args.model_name, dtype=dtype,
                              device=device)
    manifest = export_sample_program(
        model, args.out_dir, buckets=parse_buckets(args.buckets),
        num_step=args.num_step, guidance_scale=args.guidance_scale,
        t_shift=args.t_shift,
    )
    for b in manifest["buckets"]:
        logging.info(f"bucket B={b['B']} S={b['S']} T={b['T']}: exported "
                     f"in {b['export_s']:.1f} s, {b['bytes']} bytes")
    logging.info(f"exported {len(manifest['buckets'])} programs to "
                 f"{args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
