"""Spans and counters inside the offline pipeline.

Off by default.  ``enable(True)`` turns them on for the process; then
``InferencePipeline.generate_sentence`` returns its call's record in its
metrics dict under ``"trace"``, the operator's breakdown of one call:

- ``spans``: {name: {"n": occurrences, "s": host seconds}};
- ``device_s``: {name: device seconds} of the spans also timed on the
  device, between CUDA events recorded on the current stream at each end
  (on the CPU, whose work runs as it is queued, the host seconds);
- ``counters``: ``sample.row_frames`` (the sum of B x T over the bucketed
  samples), ``sample.real_frames`` (the sum of the real rows' predicted
  frames) and ``drained_s`` (host seconds in which the calling thread had
  nothing queued on the device: from a blocking copy to the host, or the
  call's start, to the next enqueue, or the call's end).

The spans:

==================== ====================================================
``zv.frontend``      the prompt's and the text's preparation; its seconds
                     are ``t_frontend``'s
``zv.sample.prepare`` a sample's bucketing, padding and noise draw, up to
                     its first upload
``zv.sample.enqueue`` the first upload to the sample's last queued op;
                     timed on the device too
``zv.step``          one Euler step of ``models/solver.py::euler_sample``
``zv.sample.copy_out`` the generated features' and lengths' copy to the
                     host
``zv.vocode``        one frame-bucket group of ``_vocode_chunks``: the mel
                     batch, its upload, the vocoder, the copy out
``zv.merge``         gain, cross-fade and silence trim of the call's wav
==================== ====================================================

While a ``torch.profiler`` records, each span also enters a
``record_function`` of its name, so that it lands in the profiler's trace
on the kernels' clock; with no profiler recording none is made.  Each site
tests ``on`` before it calls in here, so that with tracing off a site costs
that test alone: no clock reading, no CUDA event, no allocation.  No span
enters a traced or exported program or a captured CUDA graph
(``steppable``).
"""

import threading
import time
from typing import Optional

import torch

from zipvoice_torch.kernels._build import untraced

on = False
_local = threading.local()


def enable(flag: bool) -> None:
    """Turn the spans and counters on or off for the process."""
    global on
    on = bool(flag)


class _Record:
    """One call's spans and counters, open on the calling thread."""

    __slots__ = ("spans", "device_s", "counters", "events", "drained_at")

    def __init__(self, t0: float):
        self.spans = {}
        self.device_s = {}
        self.counters = {"sample.row_frames": 0, "sample.real_frames": 0,
                         "drained_s": 0.0}
        # (name, start event, end event) of the spans timed on the card
        self.events = []
        self.drained_at = t0


def _open() -> Optional[_Record]:
    return getattr(_local, "rec", None)


def begin(t0: float) -> None:
    """Open a call's record on this thread at ``t0`` (a
    ``time.perf_counter`` reading); the device counts as drained from
    there."""
    _local.rec = _Record(t0)


def finish(t1: float) -> dict:
    """Close this thread's call at ``t1`` and return its record.  The CUDA
    events are read here, after the call's last copy to the host has
    waited for them, so reading them waits for nothing."""
    rec = _open()
    _local.rec = None
    if rec.drained_at is not None:
        rec.counters["drained_s"] += t1 - rec.drained_at
    for name, start, end in rec.events:
        end.synchronize()
        rec.device_s[name] = (rec.device_s.get(name, 0.0)
                              + start.elapsed_time(end) * 1e-3)
    return {"spans": rec.spans, "device_s": rec.device_s,
            "counters": rec.counters}


class Span:
    """An open span; ``end`` closes it."""

    __slots__ = ("name", "t0", "rec", "mark", "start", "cpu")

    def end(self, t1: Optional[float] = None) -> float:
        """Close the span at ``t1`` (a reading the site already took) or
        now; returns the end's reading."""
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
        if t1 is None:
            t1 = time.perf_counter()
        rec = self.rec
        if rec is not None:
            s = rec.spans.setdefault(self.name, {"n": 0, "s": 0.0})
            s["n"] += 1
            s["s"] += t1 - self.t0
            if end is not None:
                rec.events.append((self.name, self.start, end))
            elif self.cpu:
                rec.device_s[self.name] = (rec.device_s.get(self.name, 0.0)
                                           + t1 - self.t0)
        return t1


def span(name: str, t0: Optional[float] = None,
         device: Optional[torch.device] = None) -> Span:
    """Open the span ``name`` at ``t0`` (a reading the site already took)
    or now.  With ``device`` it is also timed on that device."""
    s = Span()
    s.name = name
    s.rec = _open()
    s.mark = None
    if torch.autograd._profiler_enabled():
        s.mark = torch.profiler.record_function(name)
        s.mark.__enter__()
    s.start = None
    s.cpu = device is not None and device.type == "cpu"
    if device is not None and device.type == "cuda" and s.rec is not None:
        s.start = torch.cuda.Event(enable_timing=True)
        s.start.record()
    s.t0 = time.perf_counter() if t0 is None else t0
    return s


def count(name: str, n) -> None:
    """Add ``n`` to this thread's call's counter ``name``."""
    rec = _open()
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def queued(t: Optional[float] = None) -> None:
    """The thread has just given the device work at ``t`` (or now): the
    drained interval open since the last blocking copy ends."""
    rec = _open()
    if rec is not None and rec.drained_at is not None:
        if t is None:
            t = time.perf_counter()
        rec.counters["drained_s"] += t - rec.drained_at
        rec.drained_at = None


def drained(t: float) -> None:
    """A blocking copy to the host ended at ``t``: nothing is queued on
    the device from there to the next ``queued``."""
    rec = _open()
    if rec is not None and rec.drained_at is None:
        rec.drained_at = t


def steppable(x: torch.Tensor) -> bool:
    """Whether a per-step span may be taken around work on ``x``: not
    while ``torch.export`` or ``torch.compile`` traces (the check
    ``kernels/_build.untraced`` makes) nor while a CUDA graph is
    captured."""
    return untraced(x) and not (x.is_cuda
                                and torch.cuda.is_current_stream_capturing())
