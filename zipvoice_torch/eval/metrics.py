"""Evaluation metrics: WER, cpWER (permutation dialog WER), cosine SIM
(the port's copy of ``zipvoice_tpu/eval/metrics.py``).

Reference: zipvoice/eval/wer/*.py, speaker_similarity/*.py (~2.7K LoC of
CLI drivers around HF models).  The metric math lives here, self-contained:

- WER via Levenshtein alignment (substitutions/insertions/deletions);
- cpWER: concatenated per-speaker transcripts under the best speaker
  permutation (reference eval/wer/dialog.py:215-266);
- SIM-o: cosine similarity of speaker embeddings.
"""

import re
from itertools import permutations
from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> Dict[str, int]:
    """Levenshtein with operation counts."""
    m, n = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, ins, dels)
    dp = np.zeros((m + 1, n + 1), np.int32)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            dp[i, j] = min(
                dp[i - 1, j - 1] + cost,  # sub / match
                dp[i - 1, j] + 1,  # del
                dp[i, j - 1] + 1,  # ins
            )
    # backtrack for counts
    i, j = m, n
    subs = ins = dels = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (
            0 if ref[i - 1] == hyp[j - 1] else 1
        ):
            if ref[i - 1] != hyp[j - 1]:
                subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return {"errors": int(dp[m, n]), "subs": subs, "ins": ins, "dels": dels,
            "ref_len": m}


_PUNCT_RE = re.compile(r"[^\w\s']", re.UNICODE)


# zhon.hanzi.punctuation (CJK stops + non-stops), embedded so scoring
# matches the reference's pre-scoring normalization without the zhon dep
# (reference eval/wer/seedtts.py:38,128-151)
_CJK_PUNCT = (
    "＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､　"
    "、〃〈〉《》「」『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏﹑﹔"
    "·！？｡。"
)


def post_process(text: str, lang: str) -> str:
    """The reference's pre-scoring text normalization
    (eval/wer/seedtts.py:128-151), reproduced exactly: strip all CJK+ASCII
    punctuation EXCEPT apostrophes, one double-space collapse pass, then
    lowercase (en) or split into characters (zh)."""
    import string as _string

    for x in _CJK_PUNCT + _string.punctuation:
        if x == "'":
            continue
        text = text.replace(x, "")
    text = text.replace("  ", " ")
    if lang == "zh":
        return " ".join(x for x in text)
    return text.lower()


def normalize_text(text: str, lang: str = "en") -> List[str]:
    """Scoring tokens after the reference's post_process: whitespace-split
    words (en) / characters (zh)."""
    return post_process(text, lang).split()


def wer(ref: str, hyp: str, lang: str = "en") -> Dict[str, float]:
    r = normalize_text(ref, lang)
    h = normalize_text(hyp, lang)
    d = edit_distance(r, h)
    d["wer"] = d["errors"] / max(d["ref_len"], 1)
    return d


def corpus_wer(pairs: Sequence[Tuple[str, str]], lang: str = "en") -> float:
    errors = 0
    ref_len = 0
    for ref, hyp in pairs:
        d = wer(ref, hyp, lang)
        errors += d["errors"]
        ref_len += d["ref_len"]
    return errors / max(ref_len, 1)


def split_speakers(text: str, tags=("[S1]", "[S2]")) -> Dict[str, str]:
    """Split a dialog transcript into per-speaker concatenations."""
    parts: Dict[str, List[str]] = {t: [] for t in tags}
    current = None
    buf: List[str] = []
    tokens = re.split(r"(\[S[12]\])", text)
    for tok in tokens:
        if tok in tags:
            current = tok
        elif current is not None and tok.strip():
            parts[current].append(tok.strip())
    return {k: " ".join(v) for k, v in parts.items()}


def cpwer(ref: str, hyp: str, lang: str = "en") -> float:
    """Concatenated-permutation WER for two-speaker dialogs
    (reference eval/wer/dialog.py:215-266): per-speaker transcripts are
    concatenated and scored under the best speaker assignment."""
    ref_spk = split_speakers(ref)
    hyp_spk = split_speakers(hyp)
    tags = list(ref_spk.keys())
    best = None
    for perm in permutations(tags):
        errors = 0
        ref_len = 0
        for rt, ht in zip(tags, perm):
            d = wer(ref_spk[rt], hyp_spk[ht], lang)
            errors += d["errors"]
            ref_len += d["ref_len"]
        score = errors / max(ref_len, 1)
        best = score if best is None else min(best, score)
    return best


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(
        np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    )
