"""Speech-synthesis dataset: cuts -> padded numpy training batches (the
port's copy of ``zipvoice_tpu/data/dataset.py``).

Replaces the reference's SpeechSynthesisDataset + DataLoader stack
(reference zipvoice/dataset/dataset.py:11-106, datamodule.py) with a
host-side iterator producing padded arrays:

- features come precomputed (``.fz``/``.npy`` via bin/compute_fbank.py) or
  on the fly (the port's ``VocosFbank``, mono or stereo);
- token ids from the cut's cached ``tokens`` or by tokenizing its text;
- frame, token and batch sizes are padded up to bucketed sizes, so the
  train step sees a handful of shapes;
- a background thread prefetches batches (the reference uses DataLoader
  workers);
- in multi-process training each process can materialize only its own
  rows of the global batch (``local_rows_fn``, ``--per-host-data``): the
  batch's shapes come from every cut's metadata, the feature IO from the
  process's rows alone.
"""

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from zipvoice_torch.data.manifest import Cut
from zipvoice_torch.frontend.batch import bucket_length
from zipvoice_torch.frontend.feature import VocosFbank, compute_num_frames

FRAME_BUCKETS = tuple(128 * i for i in range(1, 32))
TOKEN_BUCKETS = tuple(32 * i for i in range(1, 32))
BATCH_BUCKETS = tuple(2 ** i for i in range(0, 10))


class SpeechSynthesisDataset:
    def __init__(
        self,
        tokenizer=None,
        on_the_fly_feats: bool = False,
        feat_scale: float = 0.1,
        sampling_rate: int = 24000,
        num_channels: int = 1,
        return_text: bool = False,
        pad_to_buckets: bool = True,
        local_rows_fn=None,
    ):
        self.tokenizer = tokenizer
        self.on_the_fly_feats = on_the_fly_feats
        self.feat_scale = feat_scale
        # local_rows_fn(padded batch size) -> the global rows this process
        # materializes (per-host data loading); None = the whole batch
        self.local_rows_fn = local_rows_fn
        self.sampling_rate = sampling_rate
        self.extractor = VocosFbank(num_channels=num_channels)
        self.return_text = return_text
        self.pad_to_buckets = pad_to_buckets

    def _features_of(self, cut: Cut) -> np.ndarray:
        if cut.features is not None and not self.on_the_fly_feats:
            return cut.load_features()
        wav = cut.load_audio(self.sampling_rate)
        return self.extractor.extract(wav, self.sampling_rate)

    def _tokens_of(self, cut: Cut) -> List[int]:
        if cut.tokens is not None:
            return self.tokenizer.tokens_to_token_ids([cut.tokens])[0]
        return self.tokenizer.texts_to_token_ids([cut.text])[0]

    def _num_frames_of(self, cut: Cut) -> int:
        """The frame count from metadata alone (no feature IO), so that
        every process derives the same global batch shapes."""
        if cut.num_frames is not None and not self.on_the_fly_feats:
            return int(cut.num_frames)
        dur = (cut.end - cut.start) if cut.end is not None else cut.duration
        n_samples = int(round(dur * self.sampling_rate))
        return compute_num_frames(n_samples, self.extractor.config.hop_length)

    def __call__(self, cuts: Sequence[Cut], local_rows=None
                 ) -> Dict[str, np.ndarray]:
        """cuts -> padded batch arrays: features (B, T, F) scaled by
        ``feat_scale``, features_lens, tokens (B, S) with at least one
        trailing pad, tokens_lens, and ``valid`` (B,), False on the rows
        that pad the batch to its bucket (copies of row 0).

        ``local_rows`` (ascending global row indices; by default
        ``local_rows_fn``'s, False for the whole batch) materializes only
        those rows of the global batch; the arrays then also carry
        ``global_batch_size``."""
        if local_rows is None and self.local_rows_fn is not None:
            B_pad = (bucket_length(len(cuts), BATCH_BUCKETS)
                     if self.pad_to_buckets else len(cuts))
            local_rows = self.local_rows_fn(B_pad)
        if local_rows is not None and local_rows is not False:
            return self._call_local(cuts, np.asarray(local_rows, np.int64))
        feats = [self._features_of(c) for c in cuts]
        token_ids = [self._tokens_of(c) for c in cuts]

        B_real = len(cuts)
        T_real = max(f.shape[0] for f in feats)
        S_real = max(len(t) for t in token_ids) + 1
        if self.pad_to_buckets:
            B = bucket_length(B_real, BATCH_BUCKETS)
            T = bucket_length(T_real, FRAME_BUCKETS)
            S = bucket_length(S_real, TOKEN_BUCKETS)
        else:
            B, T, S = B_real, T_real, S_real

        F = feats[0].shape[1]
        pad_id = self.tokenizer.pad_id if self.tokenizer else 0
        features = np.zeros((B, T, F), np.float32)
        features_lens = np.zeros((B,), np.int32)
        tokens = np.full((B, S), pad_id, np.int32)
        tokens_lens = np.zeros((B,), np.int32)
        for i, (f, tok) in enumerate(zip(feats, token_ids)):
            features[i, : f.shape[0]] = f * self.feat_scale
            features_lens[i] = f.shape[0]
            tokens[i, : len(tok)] = tok
            tokens_lens[i] = len(tok)
        # padded rows replicate row 0 so the model sees no degenerate zeros
        for i in range(B_real, B):
            features[i] = features[0]
            features_lens[i] = features_lens[0]
            tokens[i] = tokens[0]
            tokens_lens[i] = tokens_lens[0]

        batch = {
            "features": features,
            "features_lens": features_lens,
            "tokens": tokens,
            "tokens_lens": tokens_lens,
            "valid": (np.arange(B) < B_real),
        }
        if self.return_text:
            batch["text"] = [c.text for c in cuts]
            batch["ids"] = [c.id for c in cuts]
        return batch

    def _call_local(self, cuts: Sequence[Cut],
                    rows: np.ndarray) -> Dict[str, np.ndarray]:
        """Only ``rows`` of the global batch: its shapes (B, T, S) from every
        cut's metadata, the features of the rows' cuts alone.  Padded rows
        copy global row 0, as in the whole batch, so the rows equal the
        whole batch's bit for bit."""
        B_real = len(cuts)
        frame_counts = [self._num_frames_of(c) for c in cuts]
        token_ids = [self._tokens_of(c) for c in cuts]
        T_real = max(frame_counts)
        S_real = max(len(t) for t in token_ids) + 1
        if self.pad_to_buckets:
            B = bucket_length(B_real, BATCH_BUCKETS)
            T = bucket_length(T_real, FRAME_BUCKETS)
            S = bucket_length(S_real, TOKEN_BUCKETS)
        else:
            B, T, S = B_real, T_real, S_real
        if not len(rows):
            raise ValueError("this process holds no row of the batch")
        if int(rows.max()) >= B:
            raise ValueError(f"rows {rows} outside a batch of {B}")

        cache: Dict[int, np.ndarray] = {}

        def feats_of(r: int) -> np.ndarray:
            if r not in cache:
                f = self._features_of(cuts[r])
                n = frame_counts[r]
                if f.shape[0] != n:
                    # an on-the-fly cut's count from its duration can be a
                    # frame off; the metadata count is what every process
                    # agrees on, so the features follow it
                    f = f[:n] if f.shape[0] > n else np.pad(
                        f, ((0, n - f.shape[0]), (0, 0)))
                cache[r] = f
            return cache[r]

        sources = [int(r) if r < B_real else 0 for r in rows]
        F = feats_of(sources[0]).shape[1]
        pad_id = self.tokenizer.pad_id if self.tokenizer else 0
        n_local = len(rows)
        features = np.zeros((n_local, T, F), np.float32)
        features_lens = np.zeros((n_local,), np.int32)
        tokens = np.full((n_local, S), pad_id, np.int32)
        tokens_lens = np.zeros((n_local,), np.int32)
        for j, src in enumerate(sources):
            f = feats_of(src)
            features[j, : f.shape[0]] = f * self.feat_scale
            features_lens[j] = f.shape[0]
            tok = token_ids[src]
            tokens[j, : len(tok)] = tok
            tokens_lens[j] = len(tok)
        batch = {
            "features": features,
            "features_lens": features_lens,
            "tokens": tokens,
            "tokens_lens": tokens_lens,
            "valid": rows < B_real,
            "global_batch_size": B,
        }
        if self.return_text:
            real = [r for r in rows if r < B_real]
            batch["text"] = [cuts[r].text for r in real]
            batch["ids"] = [cuts[r].id for r in real]
        return batch


def prefetch_batches(
    sampler, dataset, num_prefetch: int = 4, num_workers: int = 1
) -> Iterator[Dict[str, np.ndarray]]:
    """Prefetching iterator (the reference uses 8 DataLoader worker
    processes, datamodule.py:143-151).  ``num_workers`` > 1 assembles
    several batches concurrently in a thread pool (feature IO and the
    fbank release the GIL).  Batch order is preserved, and an error in a
    batch's assembly is raised here."""
    if num_workers <= 1:
        q: "queue.Queue" = queue.Queue(maxsize=num_prefetch)
        _DONE = object()

        def worker():
            try:
                for cuts in sampler:
                    q.put(dataset(cuts))
            except BaseException as e:  # noqa: BLE001
                q.put(e)  # raised in the consumer, not lost with the thread
            finally:
                q.put(_DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        return

    from concurrent.futures import ThreadPoolExecutor

    max_inflight = max(num_prefetch, num_workers)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        inflight: "queue.Queue" = queue.Queue()
        it = iter(sampler)

        def submit_next() -> bool:
            try:
                cuts = next(it)
            except StopIteration:
                return False
            inflight.put(pool.submit(dataset, cuts))
            return True

        for _ in range(max_inflight):
            if not submit_next():
                break
        while not inflight.empty():
            fut = inflight.get()
            batch = fut.result()
            submit_next()
            yield batch
