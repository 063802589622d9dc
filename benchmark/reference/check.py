"""What the plain reference makes of one request, from the inputs the
benchmark handed the program: the offline entry's whole text -> wav
path.  Nothing here reads what the program made but the batch facts
named below."""

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import frontend as fe
from benchmark.reference import model as ref


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want||, or inf where the shapes differ."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


class Reference:
    """The reference model of one configuration on one device, with the
    weights the benchmark drew; with ``rounding`` (``model.fp8``) every
    product's inputs are rounded to it, the check's control."""

    def __init__(self, config: dict, params: Dict[str, torch.Tensor],
                 vocos_params: Dict[str, torch.Tensor], device,
                 rounding=None):
        ref.no_tf32()
        self.cfg = config["model"]
        self.voc = config["vocoder"]
        self.inf = config["inference"]
        self.P = ref.Params({k: v.float() for k, v in params.items()},
                            rounding)
        self.V = ref.Params({k: v.float() for k, v in vocos_params.items()},
                            rounding)
        self.device = device

    def sample_rows(self, token_rows: List[List[int]], prompt_feats, pfl,
                    fl: np.ndarray, T: int, noise: np.ndarray,
                    valid_max: int) -> List[np.ndarray]:
        """The generated features (n_i, F), unscaled, of rows of one batch
        that the program ran at T frames with its longest row
        ``valid_max``."""
        dev = self.device
        B = len(token_rows)
        S = max(len(t) for t in token_rows) + 1
        tok = np.full((B, S), self.cfg["pad_id"], np.int64)
        for i, t in enumerate(token_rows):
            tok[i, :len(t)] = t
        Fd = self.cfg["feat_dim"]
        pf = np.zeros((B, T, Fd), np.float32)
        for i in range(B):
            n = min(prompt_feats[i].shape[0], T)
            pf[i, :n] = prompt_feats[i][:n]
        pfl = np.minimum(np.asarray(pfl, np.int64), T)

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        with torch.no_grad():
            x1 = ref.sample(
                self.P, self.cfg, t(tok), t([len(r) for r in token_rows]),
                t(pf, torch.float32), t(pfl), t(fl), t(noise, torch.float32),
                self.inf["num_step"], self.inf["guidance_scale"],
                self.inf["t_shift"], valid_max=int(valid_max))
            rows = ref.strip(x1, fl, pfl)
        scale = self.inf["feat_scale"]
        return [r.cpu().numpy() / scale for r in rows]

    def vocode(self, feats: np.ndarray) -> np.ndarray:
        """(n * hop,) waveform of (n, F) features, vocoded as the program
        vocodes them: zero-padded to the chunk's frame bucket."""
        n = feats.shape[0]
        T = fe.bucket_length(n, fe.FRAME_BUCKETS)
        mel = np.zeros((1, T, feats.shape[1]), np.float32)
        mel[0, :n] = feats
        with torch.no_grad():
            wav = ref.vocos(self.V, self.voc,
                            torch.from_numpy(mel).to(self.device))
        return wav[0, :n * self.voc["hop_length"]].cpu().numpy()

    def offline_call(self, prompt_wav: np.ndarray, prompt_tokens: List[str],
                     text_tokens: List[str], token2id: Dict[str, int],
                     noise_seed: int, max_duration: float, speed: float
                     ) -> Tuple[List[np.ndarray], np.ndarray]:
        """The offline entry's work on one call: (each chunk's generated
        features in the order the program samples them, the final
        waveform (1, n)).  The chunking, the batch packing, each batch's
        lengths and buckets and its noise (drawn in batch order from
        ``RandomState(noise_seed)``) are worked out here."""
        inf = self.inf
        feats, rms, prompt_s = fe.prepare_prompt(
            prompt_wav, inf["feat_scale"], inf["target_rms"])
        token_s = prompt_s / (len(prompt_tokens) * speed)
        max_tokens = max(4, int((25 - prompt_s) / token_s))
        chunks = [[token2id[x] for x in c]
                  for c in fe.chunk_tokens(text_tokens, max_tokens)]
        prompt_ids = [token2id[x] for x in prompt_tokens]
        batches, order = fe.pack_batches(chunks, max_duration, prompt_s,
                                         token_s)
        rng = np.random.RandomState(noise_seed)
        out: Dict[int, np.ndarray] = {}
        sampled = []
        Fd = self.cfg["feat_dim"]
        for batch in batches:
            B = fe.bucket_length(len(batch), fe.BATCH_BUCKETS)
            pfl = np.full(len(batch), feats.shape[0], np.int32)
            fl = fe.predicted_frames(pfl, [len(prompt_ids)] * len(batch),
                                     [len(chunks[i]) for i in batch],
                                     [speed] * len(batch))
            fl = np.minimum(fl, fe.FRAME_BUCKETS[-1])
            T = fe.bucket_length(int(fl.max()), fe.FRAME_BUCKETS)
            noise = rng.randn(B, T, Fd).astype(np.float32)[:len(batch)]
            rows = self.sample_rows([prompt_ids + chunks[i] for i in batch],
                                    [feats] * len(batch), pfl, fl, T, noise,
                                    int(fl.max()))
            for i, r in zip(batch, rows):
                out[i] = r
                sampled.append(r)
        wavs = {i: self.vocode(f) for i, f in out.items()}
        if rms < inf["target_rms"]:
            wavs = {i: w * rms / inf["target_rms"] for i, w in wavs.items()}
        merged = fe.cross_fade_concat([wavs[i][None] for i in sorted(wavs)])
        final = fe.remove_silence(merged, fe.SR, only_edge=True, trail_sil=0)
        return sampled, final
