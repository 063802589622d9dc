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
  workers).

The JAX module's per-host row materialization (``local_rows_fn``) belongs
to multi-process training, which the port does not have yet (ROADMAP A5e).
"""

import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np

from zipvoice_torch.data.manifest import Cut
from zipvoice_torch.frontend.batch import bucket_length
from zipvoice_torch.frontend.feature import VocosFbank

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
    ):
        self.tokenizer = tokenizer
        self.on_the_fly_feats = on_the_fly_feats
        self.feat_scale = feat_scale
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

    def __call__(self, cuts: Sequence[Cut]) -> Dict[str, np.ndarray]:
        """cuts -> padded batch arrays: features (B, T, F) scaled by
        ``feat_scale``, features_lens, tokens (B, S) with at least one
        trailing pad, tokens_lens, and ``valid`` (B,), False on the rows
        that pad the batch to its bucket (copies of row 0)."""
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
