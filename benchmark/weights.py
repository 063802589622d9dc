"""Random weights made on the device from a seed, by the configuration's
rules, for both the program and the plain reference.

All of a model's values come from one draw of U(-1, 1) on the device's own
generator; each parameter then takes its slice, scaled by the first rule of
the configuration's ``init`` list whose pattern its name matches:

- ``["fan_in", a]``: U(+-a / sqrt(fan in)) (the in-features times the
  kernel width);
- ``["bias_fan_in", a]``: U(+-a / sqrt(fan in of the same layer's weight));
- ``["uniform", a]``: U(+-a);
- ``["around", c, a]``: c + U(+-a).

The rules follow the published models' initializations as the port's
constructors apply them, so that activations keep realistic scales.
"""

import re
from typing import Dict, Sequence

import torch


def _fan_in(shape: Sequence[int]) -> int:
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def make_weights(shapes: Dict[str, tuple], rules, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every name in ``shapes``."""
    compiled = [(re.compile(r[0]), r[1], r[2:]) for r in rules]
    sizes = [max(1, _numel(s)) for s in shapes.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device,
                      dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        u = flat[at:at + _numel(shape)].view(shape)
        at += n
        for pattern, kind, args in compiled:
            if pattern.search(name):
                break
        else:
            raise ValueError(f"no init rule matches {name}")
        if kind == "fan_in":
            out[name] = u * (args[0] / _fan_in(shape) ** 0.5)
        elif kind == "bias_fan_in":
            weight = shapes[name[: -len("bias")] + "weight"]
            out[name] = u * (args[0] / _fan_in(weight) ** 0.5)
        elif kind == "uniform":
            out[name] = u * args[0]
        elif kind == "around":
            out[name] = u * args[1] + args[0]
        else:
            raise ValueError(f"unknown init rule {kind!r} for {name}")
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
