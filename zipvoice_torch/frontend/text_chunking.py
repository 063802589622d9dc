"""Long-text handling: punctuation/dialog chunking + duration-bounded batch
packing (reference zipvoice/utils/infer.py:9-170; the port's copy of
``zipvoice_tpu/frontend/text_chunking.py``).

This is ZipVoice's alternative to sequence parallelism: constant-memory
long-form synthesis by cutting at punctuation into ~25 s windows and greedy
length-sorted packing (SURVEY.md §5 long-context notes).
"""

from typing import List, Tuple

PUNCTUATION = {";", ":", ",", ".", "!", "?", "；", "：", "，", "。", "！", "？"}


def add_punctuation(text: str) -> str:
    text = text.strip()
    if text and text[-1] not in PUNCTUATION:
        text += "."
    return text


def chunk_tokens_punctuation(
    tokens_list: List[str], max_tokens: int = 100
) -> List[List[str]]:
    """Split a token list into sentence chunks of <= max_tokens at
    punctuation boundaries (reference utils/infer.py:12-62)."""
    sentences: List[List[str]] = []
    current: List[str] = []
    for token in tokens_list:
        if (
            len(current) == 0
            and len(sentences) != 0
            and (token in PUNCTUATION or token == " ")
        ):
            sentences[-1].append(token)
        else:
            current.append(token)
            if token in PUNCTUATION:
                sentences.append(current)
                current = []
    if current:
        sentences.append(current)

    chunks: List[List[str]] = []
    cur: List[str] = []
    for sentence in sentences:
        if len(cur) + len(sentence) <= max_tokens:
            cur.extend(sentence)
        else:
            if cur:
                chunks.append(cur)
            cur = sentence
    if cur:
        chunks.append(cur)
    return chunks


def chunk_tokens_dialog(
    tokens_list: List[str], max_tokens: int = 100
) -> List[List[str]]:
    """Split at [S1] speaker turns, merging to <= max_tokens
    (reference utils/infer.py:65-105)."""
    dialogs: List[List[str]] = []
    current: List[str] = []
    for token in tokens_list:
        if token == "[S1]":
            if current:
                dialogs.append(current)
            current = []
        current.append(token)
    if current:
        dialogs.append(current)

    chunks: List[List[str]] = []
    cur: List[str] = []
    for dialog in dialogs:
        if len(cur) + len(dialog) <= max_tokens:
            cur.extend(dialog)
        else:
            if cur:
                chunks.append(cur)
            cur = dialog
    if cur:
        chunks.append(cur)
    return chunks


def batchify_tokens(
    tokens_list: List[List[int]],
    max_duration: float,
    prompt_duration: float,
    token_duration: float,
) -> Tuple[List[List[List[int]]], List[int]]:
    """Sort by length and greedily pack into duration-bounded batches;
    returns (batches, original_index) (reference utils/infer.py:108-170)."""
    indexed = sorted(enumerate(tokens_list), key=lambda x: len(x[1]))
    index = [i for i, _ in indexed]
    sorted_tokens = [t for _, t in indexed]

    batches: List[List[List[int]]] = []
    batch: List[List[int]] = []
    batch_size = 0
    for tokens in sorted_tokens:
        if (
            batch_size * token_duration
            + len(batch) * prompt_duration
            + len(tokens) * token_duration
            <= max_duration
        ):
            batch.append(tokens)
            batch_size += len(tokens)
        else:
            if batch:
                batches.append(batch)
            batch = [tokens]
            batch_size = len(tokens)
    if batch:
        batches.append(batch)
    return batches, index
