"""Duration-bucketed batch sampler with resumable state (the port's copy
of ``zipvoice_tpu/data/sampler.py``).

Replaces lhotse's DynamicBucketingSampler (reference
zipvoice/dataset/datamodule.py:177-195: max_duration seconds per batch,
30 buckets, shuffled): within a bucket, the utterances pad to the same
frame bucket, so batches take a small set of shapes.

State (epoch, batch index, rng seed) is a plain dict -> checkpointable, so
training resumes mid-epoch (the reference saves sampler state dicts,
checkpoint.py:90-93).
"""

import bisect
import random
from typing import Dict, Iterator, List, Optional, Sequence

from zipvoice_torch.data.manifest import Cut


class DynamicBucketingSampler:
    def __init__(
        self,
        cuts: Sequence[Cut],
        max_duration: float = 250.0,
        num_buckets: int = 30,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 42,
        quadratic_duration: Optional[float] = None,
    ):
        self.cuts = list(cuts)
        self.max_duration = max_duration
        self.num_buckets = num_buckets
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.quadratic_duration = quadratic_duration
        self.epoch = 0
        self._resume_batch = 0
        self._cur_batch = 0

        durations = sorted(c.duration for c in self.cuts)
        n = len(durations)
        # equal-mass duration boundaries
        self.boundaries = [
            durations[min(n - 1, (n * i) // num_buckets)]
            for i in range(1, num_buckets)
        ]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def state_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "batch": self._cur_batch,
            "seed": self.seed,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.epoch = state["epoch"]
        self._resume_batch = state["batch"]
        self.seed = state["seed"]

    def _bucket_of(self, d: float) -> int:
        return bisect.bisect_right(self.boundaries, d)

    def __iter__(self) -> Iterator[List[Cut]]:
        rng = random.Random(self.seed + self.epoch)
        order = list(range(len(self.cuts)))
        if self.shuffle:
            rng.shuffle(order)

        buckets: List[List[Cut]] = [[] for _ in range(self.num_buckets)]
        bucket_dur = [0.0] * self.num_buckets
        batches = []
        for idx in order:
            cut = self.cuts[idx]
            b = self._bucket_of(cut.duration)
            cost = self.quadratic_cost(cut.duration)
            if cost + bucket_dur[b] > self.max_duration and buckets[b]:
                batches.append(buckets[b])
                buckets[b] = []
                bucket_dur[b] = 0.0
            buckets[b].append(cut)
            bucket_dur[b] += cost
        if not self.drop_last:
            for b in range(self.num_buckets):
                if buckets[b]:
                    batches.append(buckets[b])
        if self.shuffle:
            rng.shuffle(batches)

        start = self._resume_batch
        self._resume_batch = 0
        for i, batch in enumerate(batches):
            if i < start:
                continue
            self._cur_batch = i + 1
            yield batch

    def quadratic_cost(self, d: float) -> float:
        # lhotse-style quadratic duration penalty: attention is O(T^2), so
        # long cuts cost more than their length
        if self.quadratic_duration:
            return d + (d ** 2) / self.quadratic_duration
        return d

    def __len__(self):
        total = sum(c.duration for c in self.cuts)
        return max(1, int(total / self.max_duration))


class SimpleCutSampler(DynamicBucketingSampler):
    """No bucketing: sequential duration-bounded batching
    (reference datamodule.py SimpleCutSampler path)."""

    def __init__(self, cuts, max_duration=250.0, shuffle=True, seed=42,
                 drop_last=False):
        super().__init__(
            cuts, max_duration=max_duration, num_buckets=1, shuffle=shuffle,
            seed=seed, drop_last=drop_last,
        )


class StreamingBucketingSampler:
    """Lazy, bounded-memory duration-bucketed batching for corpora that do
    not fit in RAM (the reference streams lazy lhotse CutSets through a
    buffered DynamicBucketingSampler with worker processes,
    datamodule.py:177-195; the in-memory sampler above materializes every
    cut and every batch).

    - ``cuts_fn(epoch)`` returns a fresh cut iterator per epoch (e.g.
      ``lambda ep: iter_manifest(path)`` or a lazy ``mux_iter``).
    - Memory is bounded by ``shuffle_buffer`` (streaming shuffle) plus the
      open bucket contents (< num_buckets * max_duration seconds of cut
      metadata) — independent of corpus size.
    - Duration-bucket boundaries are estimated from the first
      ``boundary_sample`` cuts of epoch 0 (lhotse estimates the same way).
    - ``rank``/``world_size`` shard the stream per training process
      (cut index % world_size == rank), replacing the reference's
      DistributedSampler-style rank split.
    - Resumable: state is (epoch, batches yielded); resume fast-forwards
      by re-streaming metadata (no feature IO).
    """

    def __init__(
        self,
        cuts_fn,
        max_duration: float = 250.0,
        num_buckets: int = 30,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 42,
        quadratic_duration: Optional[float] = None,
        shuffle_buffer: int = 10000,
        boundary_sample: int = 2000,
        rank: int = 0,
        world_size: int = 1,
    ):
        assert 0 <= rank < world_size, (rank, world_size)
        self.cuts_fn = cuts_fn
        self.max_duration = max_duration
        self.num_buckets = num_buckets
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.quadratic_duration = quadratic_duration
        self.shuffle_buffer = shuffle_buffer
        self.boundary_sample = boundary_sample
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0
        self._resume_batch = 0
        self._cur_batch = 0
        self.boundaries: Optional[List[float]] = None

    # -- sampler-state protocol (same as DynamicBucketingSampler) ----------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "batch": self._cur_batch,
                "seed": self.seed}

    def load_state_dict(self, state: Dict) -> None:
        self.epoch = state["epoch"]
        self._resume_batch = state["batch"]
        self.seed = state["seed"]

    def quadratic_cost(self, d: float) -> float:
        if self.quadratic_duration:
            return d + (d ** 2) / self.quadratic_duration
        return d

    # -- streaming machinery ------------------------------------------------
    def _sharded(self, cuts) -> Iterator[Cut]:
        if self.world_size == 1:
            return iter(cuts)
        return (cut for i, cut in enumerate(cuts)
                if i % self.world_size == self.rank)

    def _shuffled(self, cuts, rng) -> Iterator[Cut]:
        """Bounded-buffer streaming shuffle: keep `shuffle_buffer` cuts,
        emit a random one as each new cut arrives."""
        buf: List[Cut] = []
        for cut in cuts:
            if len(buf) < self.shuffle_buffer:
                buf.append(cut)
                continue
            j = rng.randrange(len(buf))
            out, buf[j] = buf[j], cut
            yield out
        rng.shuffle(buf)
        yield from buf

    def _ensure_boundaries(self, stream):
        """Estimate equal-mass duration boundaries from the stream head;
        returns the consumed head so no cut is lost."""
        if self.boundaries is not None:
            return [], stream
        head = []
        for cut in stream:
            head.append(cut)
            if len(head) >= self.boundary_sample:
                break
        durations = sorted(c.duration for c in head) or [1.0]
        n = len(durations)
        self.boundaries = [
            durations[min(n - 1, (n * i) // self.num_buckets)]
            for i in range(1, self.num_buckets)
        ]
        return head, stream

    def _bucket_of(self, d: float) -> int:
        return bisect.bisect_right(self.boundaries, d)

    def _batches(self) -> Iterator[List[Cut]]:
        rng = random.Random(self.seed + self.epoch)
        stream = self._sharded(self.cuts_fn(self.epoch))
        if self.shuffle:
            stream = self._shuffled(stream, rng)
        head, stream = self._ensure_boundaries(stream)

        def chained():
            yield from head
            yield from stream

        buckets: List[List[Cut]] = [[] for _ in range(self.num_buckets)]
        bucket_dur = [0.0] * self.num_buckets
        for cut in chained():
            b = self._bucket_of(cut.duration)
            cost = self.quadratic_cost(cut.duration)
            if cost + bucket_dur[b] > self.max_duration and buckets[b]:
                yield buckets[b]
                buckets[b] = []
                bucket_dur[b] = 0.0
            buckets[b].append(cut)
            bucket_dur[b] += cost
        if not self.drop_last:
            for b in range(self.num_buckets):
                if buckets[b]:
                    yield buckets[b]

    def __iter__(self) -> Iterator[List[Cut]]:
        start = self._resume_batch
        self._resume_batch = 0
        for i, batch in enumerate(self._batches()):
            if i < start:
                continue
            self._cur_batch = i + 1
            yield batch

    def count_batches(self) -> int:
        """Exact batch count for the CURRENT epoch via a metadata-only pass
        (no feature IO; used for the Eden epoch axis instead of the old
        total_duration/max_duration estimate)."""
        n = 0
        for _ in self._batches():
            n += 1
        return n
