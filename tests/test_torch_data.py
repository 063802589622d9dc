"""Port parity: the training data pipeline (``zipvoice_torch.data``: the
.fz feature codec, the manifests, the samplers and the dataset) against the
JAX package's ``zipvoice_tpu.data``.

The cases of the JAX package's test_featio.py, test_sampler.py and
test_streaming_sampler.py run against the port's copies; beside them, the
.fz bytes, the sampler batches (cut ids per seed, epoch and resume) and the
dataset's batch arrays are held equal to the JAX modules' on the same
inputs.  All of it is host code: no tolerance but the codec's own."""

import os
import resource

import numpy as np
import pytest

import conftest  # noqa: F401

from torch_parity import one_torch_thread  # noqa: F401
from zipvoice_torch.data import featio
from zipvoice_torch.data import sampler as port_sampler
from zipvoice_torch.data.manifest import (
    Cut,
    iter_manifest,
    mux,
    mux_iter,
    read_manifest,
    write_manifest,
)
from zipvoice_torch.data.sampler import (
    DynamicBucketingSampler,
    SimpleCutSampler,
    StreamingBucketingSampler,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# --- the .fz codec (test_featio.py) -----------------------------------------


def test_encode_decode_accuracy():
    rng = np.random.RandomState(0)
    x = (rng.randn(200, 100) * np.exp(rng.randn(200, 1))).astype(np.float32)
    q, scales = featio.encode(x)
    y = featio.decode(q, scales)
    rel = np.abs(y - x).max(axis=1) / (np.abs(x).max(axis=1) + 1e-9)
    assert rel.max() < 1e-4, rel.max()


def test_file_roundtrip_and_size(tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(500, 100).astype(np.float32)
    p = str(tmp_path / "f.fz")
    featio.save_feats(p, x)
    y = featio.load_feats(p)
    np.testing.assert_allclose(y, x, atol=2e-4 * np.abs(x).max())
    assert os.path.getsize(p) < 0.55 * x.nbytes  # ~2x compression


def test_native_matches_numpy():
    rng = np.random.RandomState(2)
    x = rng.randn(64, 80).astype(np.float32)
    lib = featio._load_lib()
    q_ref = np.clip(
        np.round(
            x / np.where(
                np.abs(x).max(axis=1) > 0,
                np.abs(x).max(axis=1) / 32767.0, 1.0
            )[:, None]
        ), -32768, 32767,
    ).astype(np.int16)
    q, scales = featio.encode(x)
    if lib is None:
        np.testing.assert_array_equal(q, q_ref)
    else:
        # native rounding is round-half-away-from-zero; allow 1 LSB
        assert np.abs(q.astype(np.int32) - q_ref.astype(np.int32)).max() <= 1


def test_zero_frames_edge():
    x = np.zeros((3, 10), np.float32)
    q, s = featio.encode(x)
    np.testing.assert_array_equal(featio.decode(q, s), x)


def test_manifest_integration(tmp_path):
    x = np.random.RandomState(3).randn(40, 100).astype(np.float32)
    p = str(tmp_path / "u0.fz")
    featio.save_feats(p, x)
    cut = Cut(id="u0", features=p, num_frames=40, duration=40 / 93.75)
    np.testing.assert_allclose(cut.load_features(), x,
                               atol=2e-4 * np.abs(x).max())


def test_fz_bytes_match_jax(tmp_path):
    """The port's .fz file is the JAX package's byte for byte, each codec
    reads the other's, and the native library sits in build/native/
    keyed by its source (the numpy codec where g++ is missing)."""
    from zipvoice_tpu.data import featio as jax_featio

    rng = np.random.RandomState(4)
    x = (rng.randn(77, 100) * np.exp(rng.randn(77, 1))).astype(np.float32)
    x[5] = 0.0
    mine, theirs = str(tmp_path / "a.fz"), str(tmp_path / "b.fz")
    featio.save_feats(mine, x)
    jax_featio.save_feats(theirs, x)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(featio.load_feats(theirs),
                                  jax_featio.load_feats(mine))
    if featio.codec() == "native":
        assert os.path.exists(featio.library_path())
        assert os.path.dirname(featio.library_path()) == featio.BUILD_DIR


# --- the in-memory sampler (test_sampler.py) ---------------------------------


def _cuts(n=50, seed=0):
    rng = np.random.RandomState(seed)
    return [Cut(id=f"c{i}", duration=float(rng.uniform(1.0, 12.0)))
            for i in range(n)]


def _ids(batches):
    return [[c.id for c in b] for b in batches]


def test_batches_respect_max_duration():
    cuts = _cuts()
    sampler = DynamicBucketingSampler(cuts, max_duration=30.0, num_buckets=5,
                                      shuffle=True, seed=1)
    seen = set()
    for batch in sampler:
        total = sum(c.duration for c in batch)
        # a single cut may exceed the budget; otherwise respect it
        assert total <= 30.0 or len(batch) == 1
        for c in batch:
            assert c.id not in seen
            seen.add(c.id)
    assert len(seen) == len(cuts)


def test_bucketing_limits_padding_waste():
    sampler = DynamicBucketingSampler(_cuts(200), max_duration=40.0,
                                      num_buckets=10, shuffle=True, seed=2)
    for batch in sampler:
        durs = [c.duration for c in batch]
        if len(durs) >= 3:
            assert max(durs) / min(durs) < 3.0, durs


def test_deterministic_per_epoch_and_resume():
    cuts = _cuts(60, seed=3)
    s1 = DynamicBucketingSampler(cuts, max_duration=25.0, seed=7)
    s1.set_epoch(2)
    full = _ids(s1)
    s2 = DynamicBucketingSampler(cuts, max_duration=25.0, seed=7)
    s2.set_epoch(2)
    assert _ids(s2) == full  # same epoch+seed -> same order
    # consume 3 batches, snapshot state, resume elsewhere
    s3 = DynamicBucketingSampler(cuts, max_duration=25.0, seed=7)
    s3.set_epoch(2)
    it = iter(s3)
    for _ in range(3):
        next(it)
    s4 = DynamicBucketingSampler(cuts, max_duration=25.0, seed=7)
    s4.load_state_dict(s3.state_dict())
    assert _ids(s4) == full[3:], "resume must continue mid-epoch"
    s5 = DynamicBucketingSampler(cuts, max_duration=25.0, seed=7)
    s5.set_epoch(3)
    assert _ids(s5) != full


@pytest.mark.parametrize("kind", ["dynamic", "simple", "streaming"])
def test_sampler_batches_match_jax(kind):
    """Each sampler names the JAX package's cut ids batch for batch, for
    two seeds and two epochs, with and without drop_last and the quadratic
    cost, and after a mid-epoch resume; the state dicts are equal."""
    from zipvoice_tpu.data import manifest as jm
    from zipvoice_tpu.data import sampler as js

    cuts = _cuts(90, seed=5)
    jcuts = [jm.Cut(id=c.id, duration=c.duration) for c in cuts]

    def make(mod, cs, seed, drop_last, quad):
        if kind == "simple":
            return mod.SimpleCutSampler(cs, max_duration=30.0, seed=seed,
                                        drop_last=drop_last)
        kw = dict(max_duration=30.0, num_buckets=6, seed=seed,
                  drop_last=drop_last, quadratic_duration=quad)
        if kind == "streaming":
            return mod.StreamingBucketingSampler(
                lambda ep: iter(cs), shuffle_buffer=20, boundary_sample=40,
                **kw)
        return mod.DynamicBucketingSampler(cs, **kw)

    for seed, drop_last, quad in ((1, False, None), (9, True, 20.0)):
        for epoch in (0, 3):
            mine = make(port_sampler, cuts, seed, drop_last, quad)
            theirs = make(js, jcuts, seed, drop_last, quad)
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = _ids(mine), _ids(theirs)
            assert got == want and len(got) > 2
            assert mine.state_dict() == theirs.state_dict()
            for s in (mine, theirs):
                s.load_state_dict(dict(s.state_dict(), batch=2))
            assert _ids(mine) == _ids(theirs) == want[2:]
    assert isinstance(SimpleCutSampler(cuts), DynamicBucketingSampler)


# --- the streaming sampler (test_streaming_sampler.py) -----------------------


def _synthetic_cuts(n, seed=0):
    """test_streaming_sampler.py's stream: the same durations, drawn in one
    call (a scalar draw a cut costs more than the sampler)."""
    durations = np.random.RandomState(seed).uniform(1, 20, n)
    for i, d in enumerate(durations):
        yield Cut(id=f"c{i}", text="hi", duration=float(d))


def test_bounded_memory_over_large_stream():
    """Iterating a 300k-cut stream keeps RSS growth bounded (the old
    in-memory sampler would hold every cut and every batch)."""
    N = 300_000
    sampler = StreamingBucketingSampler(
        lambda ep: _synthetic_cuts(N), max_duration=100.0, num_buckets=20,
        shuffle=True, seed=1, shuffle_buffer=2000,
    )
    # warm-up epoch: allocator + boundary tables
    assert sum(1 for _ in sampler) > 0
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    sampler.set_epoch(1)
    n1 = total = 0
    for batch in sampler:
        n1 += 1
        total += len(batch)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert total == N
    assert n1 > 10_000  # ~300k cuts * ~10.5s / 100s-per-batch
    assert rss1 - rss0 < 50 * 1024, (rss0, rss1)  # <50MB growth (KB units)


def test_sharding_partitions_the_stream():
    N = 5000
    seen = []
    for rank in range(4):
        s = StreamingBucketingSampler(
            lambda ep: _synthetic_cuts(N), max_duration=50.0,
            shuffle=False, rank=rank, world_size=4,
        )
        ids = [c.id for batch in s for c in batch]
        assert len(ids) == N // 4
        seen.extend(ids)
    assert sorted(seen) == sorted(f"c{i}" for i in range(N))


def test_resume_skips_consumed_batches():
    N = 3000

    def make():
        return StreamingBucketingSampler(
            lambda ep: _synthetic_cuts(N), max_duration=60.0, shuffle=True,
            seed=7, shuffle_buffer=500)

    all_batches = _ids(make())
    s2 = make()
    it = iter(s2)
    for _ in range(10):
        next(it)
    state = s2.state_dict()
    assert state["batch"] == 10
    s3 = make()
    s3.load_state_dict(state)
    assert _ids(s3) == all_batches[10:]


def test_batches_respect_duration_budget_and_buckets():
    s = StreamingBucketingSampler(
        lambda ep: _synthetic_cuts(4000), max_duration=80.0, num_buckets=10,
        shuffle=True, seed=3, drop_last=True,
    )
    for batch in s:
        assert sum(c.duration for c in batch) <= 80.0 + 1e-6
        ds = [c.duration for c in batch]
        if len(ds) > 1:
            assert max(ds) / min(ds) < 4.0, ds


def test_mux_iter_lazy_and_weighted(tmp_path):
    a = [Cut(id=f"a{i}", duration=2.0) for i in range(200)]
    b = [Cut(id=f"b{i}", duration=2.0) for i in range(100)]
    write_manifest(str(tmp_path / "a.jsonl"), a)
    write_manifest(str(tmp_path / "b.jsonl"), b)
    out = list(mux_iter(
        [lambda: iter_manifest(str(tmp_path / "a.jsonl")),
         lambda: iter_manifest(str(tmp_path / "b.jsonl"))],
        weights=[2.0, 1.0], seed=0,
    ))
    assert len(out) == 300
    assert {c.id for c in out} == {c.id for c in a + b}
    first_hundred = [c.id[0] for c in out[:100]]
    assert "a" in first_hundred and "b" in first_hundred


def test_count_batches_matches_iteration():
    s = StreamingBucketingSampler(
        lambda ep: _synthetic_cuts(2000), max_duration=70.0, shuffle=True,
        seed=11,
    )
    assert s.count_batches() == sum(1 for _ in s)


def test_multiworker_prefetch_order_and_content():
    from zipvoice_torch.data.dataset import prefetch_batches

    batches = [[i, i + 1] for i in range(0, 40, 2)]

    class FakeDataset:
        def __call__(self, cuts):
            return {"ids": list(cuts)}

    got = [b["ids"] for b in prefetch_batches(
        iter(batches), FakeDataset(), num_prefetch=4, num_workers=4)]
    assert got == batches


def test_prefetch_raises_a_failed_batch():
    """A batch whose assembly fails raises in the consumer, with either
    worker count, instead of ending the epoch early."""
    from zipvoice_torch.data.dataset import prefetch_batches

    def dataset(cuts):
        if cuts == [2]:
            raise ValueError("bad cut")
        return {"ids": cuts}

    for workers in (1, 3):
        got = []
        with pytest.raises(ValueError, match="bad cut"):
            for b in prefetch_batches(iter([[0], [1], [2], [3]]), dataset,
                                      num_workers=workers):
                got.append(b["ids"])
        assert got == [[0], [1]]


# --- manifests and the dataset against the JAX modules -----------------------


def test_manifests_and_mux_match_jax(tmp_path):
    """A manifest the port writes is the JAX package's file, line for
    line, and reads back to equal cuts; ``mux`` and ``mux_iter`` interleave
    in the JAX package's order."""
    from zipvoice_tpu.data import manifest as jm

    cuts = [Cut(id=f"u{i}", wav=f"w{i}.wav", text=f"text {i}",
                duration=1.0 + i, tokens=["a", "b"] if i % 2 else None,
                start=0.5 * (i % 3), end=None if i % 2 else 2.0 + i,
                extra={"speaker": f"s{i % 2}"}) for i in range(6)]
    jcuts = [jm.Cut.from_dict(c.to_dict()) for c in cuts]
    mine, theirs = tmp_path / "m.jsonl.gz", tmp_path / "j.jsonl.gz"
    write_manifest(str(mine), cuts)
    jm.write_manifest(str(theirs), jcuts)
    import gzip

    with gzip.open(mine, "rt") as f, gzip.open(theirs, "rt") as g:
        assert f.read() == g.read()
    assert [c.to_dict() for c in read_manifest(str(theirs))] == \
        [c.to_dict() for c in cuts]
    a = [Cut(id=f"a{i}", duration=1.0) for i in range(30)]
    b = [Cut(id=f"b{i}", duration=1.0) for i in range(20)]
    ja = [jm.Cut(id=c.id, duration=1.0) for c in a]
    jb = [jm.Cut(id=c.id, duration=1.0) for c in b]
    assert [c.id for c in mux([a, b], [3.0, 1.0], seed=4)] == \
        [c.id for c in jm.mux([ja, jb], [3.0, 1.0], seed=4)]
    assert [c.id for c in mux_iter([lambda: a, lambda: b], [1.0, 2.0],
                                   seed=5)] == \
        [c.id for c in jm.mux_iter([lambda: ja, lambda: jb], [1.0, 2.0],
                                   seed=5)]


@pytest.mark.parametrize("channels", [1, 2])
def test_dataset_batches_match_jax(tmp_path, channels):
    """``SpeechSynthesisDataset`` on the same cuts gives the JAX package's
    batch arrays: precomputed .fz features and cached tokens equal, and the
    on-the-fly fbank (mono, and stereo with ``num_channels=2``) within the
    fbank tolerance of test_torch_frontend.py; lengths, tokens, padding to
    the bucket ladders and the pad rows equal."""
    from zipvoice_tpu.data import dataset as jd
    from zipvoice_tpu.data import manifest as jm
    from zipvoice_tpu.frontend.tokenizer import SimpleTokenizer as JaxTok

    from zipvoice_torch.data.dataset import SpeechSynthesisDataset
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.frontend.tokenizer import SimpleTokenizer
    from zipvoice_torch.infer.workload import speech_like_wav

    chars = ["_"] + list("abcdefghijklmnopqrstuvwxyz .")
    token_file = tmp_path / "tokens.txt"
    token_file.write_text("".join(f"{c}\t{i}\n" for i, c in enumerate(chars)))
    cuts = []
    for i, sec in enumerate((0.9, 1.3, 0.7)):
        wav = speech_like_wav(i, seconds=sec)
        if channels == 2:
            wav = np.concatenate([wav, 0.5 * wav[:, ::-1]])
        path = str(tmp_path / f"u{i}.wav")
        save_wav(path, wav, 24000)
        feats = str(tmp_path / f"u{i}.fz")
        featio.save_feats(feats, np.random.RandomState(i).randn(
            40 + 9 * i, 100 * channels).astype(np.float32))
        cuts.append(Cut(id=f"u{i}", wav=path, text=f"cut number {i}.",
                        duration=sec, features=feats,
                        tokens=list("abc" * (i + 1)) if i == 1 else None))
    jcuts = [jm.Cut.from_dict(c.to_dict()) for c in cuts]
    for on_the_fly in (False, True):
        kw = dict(on_the_fly_feats=on_the_fly, num_channels=channels,
                  feat_scale=0.1, return_text=True)
        got = SpeechSynthesisDataset(SimpleTokenizer(str(token_file)),
                                     **kw)(cuts)
        want = jd.SpeechSynthesisDataset(JaxTok(str(token_file)),
                                         **kw)(jcuts)
        assert set(got) == set(want) - {"global_batch_size"}
        for k in ("features_lens", "tokens", "tokens_lens", "valid",
                  "text", "ids"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["features"].shape == want["features"].shape == (
            4, 128, 100 * channels)
        if not on_the_fly:
            np.testing.assert_array_equal(got["features"], want["features"])
        else:
            g, w = got["features"] / 0.1, want["features"] / 0.1
            mel = np.exp(w)
            keep = mel > 1e-4
            d = np.abs(g - w)[keep]
            assert (d / (1e-4 + 2e-6 / mel[keep])).max() <= 1.0
