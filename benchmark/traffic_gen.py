"""The one generator of every traffic mix: corpus passages and synthetic
prompts, by the parameters of a mix's file (``traffic/<mix>.json``); what
the run's seed draws is said at each.  Host only; no torch."""

import json
import os
from typing import Dict, List

from benchmark.data.speech import speech_like_wav
from benchmark.harness import BENCH_DIR, seed_for

SR = 24000


class Corpus:
    """The frozen English corpus, each sentence's phone tokens as the
    program's tokenizer gave them when the benchmark was frozen (a
    passage's tokens are its sentences' tokens one after another), and
    the token table."""

    def __init__(self, data_dir: str = os.path.join(BENCH_DIR, "data")):
        with open(os.path.join(data_dir, "en_stream_corpus.txt"),
                  encoding="utf-8") as f:
            self.sentences = [s.strip() for s in f if s.strip()]
        with open(os.path.join(data_dir, "corpus_phones.json"),
                  encoding="utf-8") as f:
            self.phones: List[List[str]] = json.load(f)
        self.token2id: Dict[str, int] = {}
        with open(os.path.join(data_dir, "tokens.txt"), encoding="utf-8") as f:
            for line in f:
                tok, idx = line.rstrip("\n").split("\t")
                self.token2id[tok] = int(idx)
        self.tokens_path = os.path.join(data_dir, "tokens.txt")
        if len(self.phones) != len(self.sentences):
            raise ValueError("corpus and phones differ in length")

    def span(self, start: int, count: int):
        """(text, phone tokens) of ``count`` sentences from ``start``,
        wrapping at the end of the corpus."""
        idx = [(start + j) % len(self.sentences) for j in range(count)]
        text = " ".join(self.sentences[i] for i in idx)
        return text, [t for i in idx for t in self.phones[i]]

    def ids(self, phones: List[str]) -> List[int]:
        return [self.token2id[t] for t in phones]


def prompts(corpus: Corpus, spec: dict) -> List[dict]:
    """The mix's synthetic prompts: for each corpus sentence that
    ``spec["sentences"]`` names, that sentence as the prompt's text and a
    waveform whose voiced part lasts its phone count at
    ``spec["tokens_per_s"]`` (less the 0.4 s of edge and trailing silence
    that the prompt's preparation leaves).  The waveform is drawn from the
    sentence's index, not from the run's seed: how much of its quiet edges
    the preparation trims sets the prompt's length, and with it how the
    pipeline chunks every text, so a seed would change the work."""
    edge = spec["edge_silence_s"]
    out = []
    for i in spec["sentences"]:
        voiced = len(corpus.phones[i]) / spec["tokens_per_s"] - 0.4
        wav = speech_like_wav(i, seconds=voiced + 2 * edge, sr=SR,
                              edge_silence=edge)
        out.append({"text": corpus.sentences[i], "phones": corpus.phones[i],
                    "wav": wav})
    return out


def passages(corpus: Corpus, spec: dict) -> List[dict]:
    """The offline pool: one passage per ``[start, count]`` entry of
    ``spec["spans"]``, with the prompt its position names (entry i takes
    prompt i mod ``spec["prompts"]``), in the file's order.  The seed draws
    none of it: a window holds a cycle and a part of the next, and the
    passages' batches differ in padding, so an order drawn from the seed
    would change the window's work."""
    out = []
    for i, (start, count) in enumerate(spec["spans"]):
        text, phones = corpus.span(start, count)
        out.append({"text": text, "phones": phones, "sentences": count,
                    "prompt": i % spec["prompts"]})
    return out


def offline_call(i: int, pool: List[dict], seed: int):
    """Call ``i`` of the offline loop: (passage, its prompt's index, noise
    seed); the pool is cycled in order."""
    passage = pool[i % len(pool)]
    return passage, passage["prompt"], seed_for(seed, "call-noise", i)
