"""Dataset manifests: a jsonl-based replacement for lhotse CutSets (the
port's copy of ``zipvoice_tpu/data/manifest.py``).

The reference stores corpora as lhotse manifests with lilcom-compressed
features (reference zipvoice/bin/prepare_dataset.py, compute_fbank.py).
Here a dataset is a ``.jsonl[.gz]`` file of utterance records:

  {"id": str, "wav": path, "text": str, "duration": float,
   ["tokens": [str, ...]], ["features": path.npy, "num_frames": int],
   ["start": float, "end": float]}

plus optional sharded ``.npy`` feature files written by
bin/compute_fbank.py.  Everything is plain files — no C extensions.
"""

import gzip
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional


@dataclass
class Cut:
    id: str
    wav: Optional[str] = None
    text: Optional[str] = None
    duration: float = 0.0
    tokens: Optional[List[str]] = None
    features: Optional[str] = None
    num_frames: Optional[int] = None
    start: float = 0.0
    end: Optional[float] = None
    extra: Dict = field(default_factory=dict)

    def to_dict(self):
        d = {"id": self.id, "duration": self.duration}
        for k in ("wav", "text", "tokens", "features", "num_frames"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.start:
            d["start"] = self.start
        if self.end is not None:
            d["end"] = self.end
        d.update(self.extra)
        return d

    @classmethod
    def from_dict(cls, d):
        known = {k: d.get(k) for k in
                 ("id", "wav", "text", "tokens", "features", "num_frames")}
        return cls(
            duration=d.get("duration", 0.0),
            start=d.get("start", 0.0),
            end=d.get("end"),
            extra={k: v for k, v in d.items()
                   if k not in ("id", "wav", "text", "tokens", "features",
                                "num_frames", "duration", "start", "end")},
            **known,
        )

    def load_features(self):
        assert self.features is not None, self.id
        if self.features.endswith(".fz"):
            from zipvoice_torch.data.featio import load_feats

            return load_feats(self.features)
        import numpy as np

        return np.load(self.features)

    def load_audio(self, target_sr: int = 24000):
        from zipvoice_torch.frontend.audio import load_wav

        wav = load_wav(self.wav, target_sr)
        if self.end is not None:
            s = int(self.start * target_sr)
            e = int(self.end * target_sr)
            wav = wav[:, s:e]
        return wav


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t", encoding="utf-8")
    return open(path, mode, encoding="utf-8")


def read_manifest(path: str) -> List[Cut]:
    with _open(path, "r") as f:
        return [Cut.from_dict(json.loads(line)) for line in f if line.strip()]


def iter_manifest(path: str) -> Iterator[Cut]:
    with _open(path, "r") as f:
        for line in f:
            if line.strip():
                yield Cut.from_dict(json.loads(line))


def write_manifest(path: str, cuts) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open(path, "w") as f:
        for cut in cuts:
            f.write(json.dumps(cut.to_dict(), ensure_ascii=False) + "\n")


def mux_iter(
    iterator_fns, weights: List[float], seed: int = 0
) -> Iterator[Cut]:
    """Lazy weighted interleave of several cut streams (lhotse
    CutSet.mux semantics, reference train_zipvoice.py:1000-1011) holding
    only one pending cut per stream in memory."""
    import random as _random

    rng = _random.Random(seed)
    iters = [iter(fn()) for fn in iterator_fns]
    pending = []
    for it in iters:
        try:
            pending.append(next(it))
        except StopIteration:
            pending.append(None)
    w = list(weights)
    while any(p is not None for p in pending):
        alive = [i for i in range(len(iters)) if pending[i] is not None]
        i = rng.choices(alive, weights=[w[j] for j in alive])[0]
        yield pending[i]
        try:
            pending[i] = next(iters[i])
        except StopIteration:
            pending[i] = None


def mux(manifests: List[List[Cut]], weights: List[float], seed: int = 0):
    """Weighted random interleave of several cut lists (replacement for
    lhotse CutSet.mux, reference train_zipvoice.py:1000-1011)."""
    import random as _random

    rng = _random.Random(seed)
    iters = [list(m) for m in manifests]
    for m in iters:
        rng.shuffle(m)
    positions = [0] * len(iters)
    total = [len(m) for m in iters]
    w = list(weights)
    out = []
    while any(positions[i] < total[i] for i in range(len(iters))):
        alive = [i for i in range(len(iters)) if positions[i] < total[i]]
        wa = [w[i] for i in alive]
        i = rng.choices(alive, weights=wa)[0]
        out.append(iters[i][positions[i]])
        positions[i] += 1
    return out
