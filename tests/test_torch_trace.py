"""The offline pipeline's spans and counters (``utils/trace.py``) on the
CPU, at TINY widths with 2 steps: with tracing off a call takes no reading
of the clock beyond its stamps, makes no ``record_function`` and returns no
record; with it on the wav is the same bits, every span and counter is
there and lands in a profiler's trace, the frame counters give the padded
share that the benchmark's ``pad_share`` reads, and no span enters an
exported program."""

import json
import os
import threading
import time

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from torch_parity import one_torch_thread  # noqa: F401
from zipvoice_torch.utils import trace

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = {"zv.frontend", "zv.sample.prepare", "zv.sample.enqueue", "zv.step",
         "zv.sample.copy_out", "zv.vocode", "zv.merge"}
NUM_STEP = 2
# two chunks (each tag is a token toward the chunk budget, with no id); at
# a 3 s batch budget each is a batch of its own, in a frame bucket of its
# own, so the call has two samples and two vocoder groups
TEXT = ("[breath]" * 140 + " We walked home. " + "[breath]" * 140
        + " The birds sang.")
# generate_sentence's own clock readings (its stamps)
STAMPS = 4


def _counting(fn, counts, key):
    """``fn``, counting its calls from this thread (another thread of the
    test process may read the clock meanwhile)."""
    caller = threading.get_ident()

    def counted(*a, **kw):
        counts[key] += threading.get_ident() == caller
        return fn(*a, **kw)
    return counted


def _refuse(*a, **kw):
    raise AssertionError("a CUDA event was made")


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """The same call (noise seed 3), tracing off then on, each under a CPU
    profiler with the clock, ``record_function`` and CUDA events watched:
    {off|on: (wav, metrics, counts, user annotations, sample records)},
    the records as the benchmark's ``record_sample_calls`` keeps them."""
    from benchmark.drivers.program import record_sample_calls
    from zipvoice_torch.bin.make_model_dir import (
        TINY_CONFIG,
        TINY_VOCOS,
        make_model_dir,
    )
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import speech_like_wav
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos

    out = tmp_path_factory.mktemp("model")
    make_model_dir(str(out), config=TINY_CONFIG, seed=4,
                   vocos_config=TINY_VOCOS)
    prompt = str(out / "prompt.wav")
    save_wav(prompt, speech_like_wav(7, seconds=2.0), 24000)
    model, tokenizer = load_model_dir(str(out), device="cpu")
    pipe = InferencePipeline(
        model, load_vocos(str(out / "pytorch_model.bin"), device="cpu"),
        device="cpu", tokenizer=tokenizer)
    records = []
    record_sample_calls(pipe, records)
    got = {}
    try:
        for on in (False, True):
            trace.enable(on)
            pipe.rng = np.random.RandomState(3)
            del records[:]
            counts = {"clock": 0, "record_function": 0}
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(time, "perf_counter", _counting(
                        time.perf_counter, counts, "clock"))
                    mp.setattr(torch.profiler, "record_function", _counting(
                        torch.profiler.record_function, counts,
                        "record_function"))
                    mp.setattr(torch.cuda, "Event", _refuse)
                    wav, m = pipe.generate_sentence(
                        "Hi, there, my friend.", prompt, TEXT,
                        num_step=NUM_STEP, max_duration=3.0)
            path = str(out / f"trace_{on}.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                marks = [e["name"] for e in json.load(f)["traceEvents"]
                         if e.get("cat") == "user_annotation"]
            got["on" if on else "off"] = (wav, m, counts, marks,
                                          list(records))
    finally:
        trace.enable(False)
    return got


def test_tracing_off_takes_no_reading_and_leaves_no_record(calls):
    _, m, counts, marks, records = calls["off"]
    assert "trace" not in m
    assert counts == {"clock": STAMPS, "record_function": 0}
    assert not [n for n in marks if n.startswith("zv.")]
    assert len(records) == 2


def test_tracing_leaves_the_wav_as_it_was(calls):
    assert np.array_equal(calls["off"][0], calls["on"][0])


def test_tracing_on_records_every_span_on_the_profilers_clock(calls):
    _, m, counts, marks, _ = calls["on"]
    rec = m["trace"]
    assert set(rec["spans"]) == SPANS
    # the span reuses the stamps: the same seconds, not close ones
    assert rec["spans"]["zv.frontend"]["s"] == m["t_frontend"]
    n = {name: s["n"] for name, s in rec["spans"].items()}
    assert n == {"zv.frontend": 1, "zv.sample.prepare": 2,
                 "zv.sample.enqueue": 2, "zv.step": 2 * NUM_STEP,
                 "zv.sample.copy_out": 2, "zv.vocode": 2, "zv.merge": 1}
    # each span once in the profiler's trace, as a user annotation
    assert {name: marks.count(name) for name in SPANS} == n
    assert counts["record_function"] == sum(n.values())
    assert rec["counters"]["drained_s"] > 0
    # on the CPU the device runs the sample as it is queued
    assert (rec["device_s"]["zv.sample.enqueue"]
            == rec["spans"]["zv.sample.enqueue"]["s"])


def test_frame_counters_give_the_benchmarks_pad_share(calls):
    from benchmark import harness

    pad_share = harness.load_file(os.path.join(
        REPO, "benchmark", "metrics", "pad_share.py"))
    _, m, _, _, records = calls["on"]
    c = m["trace"]["counters"]
    assert c["sample.row_frames"] == sum(r["B"] * r["T"] for r in records)
    assert c["sample.real_frames"] == sum(sum(r["fl"]) for r in records)
    assert (100.0 * (c["sample.row_frames"] - c["sample.real_frames"])
            / c["sample.row_frames"]
            == pad_share.read({"sample_calls": records}))


def test_drained_time_runs_from_a_copy_out_to_the_next_enqueue():
    trace.enable(True)
    try:
        trace.begin(10.0)
        trace.queued(10.5)
        trace.drained(11.0)
        trace.drained(11.25)  # already drained: the interval began at 11
        trace.queued(12.0)
        trace.queued(12.5)  # already queued
        trace.drained(13.0)
        rec = trace.finish(13.5)
    finally:
        trace.enable(False)
    assert rec["counters"]["drained_s"] == 0.5 + 1.0 + 0.5


def test_no_step_span_enters_an_exported_program():
    """``euler_sample`` exported with tracing on, under a profiler: the
    program holds no profiler operator and the export records no step;
    the module run eagerly records each."""
    from zipvoice_torch.models.solver import euler_sample

    class Sampler(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 4)

        def forward(self, x, tc, sc, pm):
            def velocity(t, x, tc, sc, pm, gs):
                return self.lin(x + tc + sc) * t[:, None, None]
            return euler_sample(velocity, x, tc, sc, pm, num_step=3,
                                guidance_scale=1.0, t_shift=0.5)

    g = torch.Generator().manual_seed(0)
    args = tuple(torch.randn(2, 5, 4, generator=g) for _ in range(3)) + (
        torch.zeros(2, 5, dtype=torch.bool),)
    sampler = Sampler()
    trace.enable(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            trace.begin(time.perf_counter())
            ep = torch.export.export(sampler, args, strict=False)
            exported = trace.finish(time.perf_counter())
            trace.begin(time.perf_counter())
            with torch.no_grad():
                sampler(*args)
            eager = trace.finish(time.perf_counter())
    finally:
        trace.enable(False)
    assert not [n for n in ep.graph.nodes if "profiler" in str(n.target)]
    assert "zv.step" not in exported["spans"]
    assert eager["spans"]["zv.step"]["n"] == 3


def test_probe_reads_launches_and_idle_gaps_by_span():
    """``torch_trace_probe.py``'s readers of a profiler's trace, on a
    hand-made one (microseconds)."""
    import torch_trace_probe as probe

    def ev(cat, name, ts, dur=0):
        return {"cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        ev("user_annotation", "bench_slice", 0, 1000),
        ev("kernel", "a", 100, 100), ev("kernel", "b", 150, 150),
        ev("kernel", "c", 600, 100),
        ev("user_annotation", "zv.vocode", 0, 50),
        ev("user_annotation", "zv.merge", 250, 150),
        ev("user_annotation", "zv.frontend", 450, 100),
        ev("user_annotation", "zv.step", 650, 30),
        ev("user_annotation", "zv.step", 800, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 655),
        ev("cuda_runtime", "cudaLaunchKernelExC", 679),
        ev("cuda_runtime", "cudaMemcpyAsync", 660),
        ev("cuda_runtime", "cudaLaunchKernel", 690),
        ev("cuda_runtime", "cudaLaunchKernel", 810),
    ]
    assert probe.step_launches(events) == (3, 2)
    got = probe.idle_gaps_by_span(events)
    assert [g[:2] for g in got] == [[300.0 * 1e-3, 300.0 * 1e-3],
                                    [300.0 * 1e-3, 700.0 * 1e-3],
                                    [100.0 * 1e-3, 0.0]]
    assert got[0][2] == pytest.approx(
        {"zv.merge": 0.1, "zv.frontend": 0.1, "between calls": 0.1})
    assert got[1][2] == pytest.approx({"zv.step": 0.02,
                                       "between calls": 0.28})
    assert got[2][2] == pytest.approx({"zv.vocode": 0.05,
                                       "between calls": 0.05})
