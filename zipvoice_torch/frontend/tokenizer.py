"""Tokenizers for the ZipVoice model family (the port's copy of
``zipvoice_tpu/frontend/tokenizer.py``).

Mirrors the reference tokenizer suite (zipvoice/tokenizer/tokenizer.py):
SimpleTokenizer (char), EspeakTokenizer (any espeak voice), EmiliaTokenizer
(bilingual zh/en with language segmentation, jieba+pinyin for zh, espeak for
en, <pinyin> overrides and [tag] passthrough), DialogTokenizer ([S1]/[S2]
speaker turns), LibriTTSTokenizer (char/phone).

Token files are ``{token}\t{id}`` lines, pad token ``_``; OOV tokens are
silently skipped (reference tokenizer.py:117-120) so ids feed the embedding
identically.

Optional third-party pieces degrade gracefully:
- espeak-ng G2P via ctypes (frontend/g2p.py), char fallback otherwise;
- hanzi->pinyin prefers pypinyin's data tables when importable (exact
  reference behavior); otherwise frontend/zh_g2p.py supplies a
  self-contained lexicon G2P (greedy longest-match segmentation + the
  same tone-sandhi rules; extend with $ZIPVOICE_PINYIN_LEXICON, TSV or
  CC-CEDICT format).  The pinyin initial/final split itself (tone3 style)
  is rule-based and implemented here (reference tokenizer.py:348-367).
"""

import logging
import re
from functools import reduce
from typing import Dict, List, Optional

from zipvoice_torch.frontend.g2p import phonemize_espeak
from zipvoice_torch.frontend.normalizer import (
    ChineseTextNormalizer,
    EnglishTextNormalizer,
)

# pinyin initials, longest first (pypinyin non-strict set)
_PINYIN_INITIALS = [
    "zh", "ch", "sh",
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "r", "z", "c", "s", "y", "w",
]


def split_pinyin(pinyin: str) -> List[str]:
    """'yang2' -> ['y0', 'ang2']: initial gets a trailing '0' so it never
    collides with espeak tokens; final keeps the tone digit, neutral tone
    becomes '5' (reference tokenizer.py:348-367)."""
    tone = pinyin[-1] if pinyin[-1] in "12345" else None
    body = pinyin[:-1] if tone else pinyin
    if tone is None:
        tone = "5"  # neutral_tone_with_five
    initial = ""
    for cand in _PINYIN_INITIALS:
        if body.startswith(cand):
            initial = cand
            break
    final = body[len(initial):]
    out = []
    if initial:
        out.append(initial + "0")
    if final:
        out.append(final + tone)
    return out


def _load_token_file(token_file: str) -> Dict[str, int]:
    token2id: Dict[str, int] = {}
    with open(token_file, "r", encoding="utf-8") as f:
        for line in f.readlines():
            info = line.rstrip().split("\t")
            token, idx = info[0], int(info[1])
            assert token not in token2id, token
            token2id[token] = idx
    return token2id


class _TokenFileMixin:
    def _init_tokens(self, token_file: Optional[str]):
        self.has_tokens = False
        if token_file is None:
            return
        self.token2id = _load_token_file(token_file)
        self.pad_id = self.token2id["_"]
        self.vocab_size = len(self.token2id)
        self.has_tokens = True

    def tokens_to_token_ids(
        self, tokens_list: List[List[str]]
    ) -> List[List[int]]:
        assert self.has_tokens, "Tokenizer needs a tokens file to map to ids"
        out = []
        for tokens in tokens_list:
            ids = []
            for t in tokens:
                if t not in self.token2id:
                    logging.debug(f"Skip OOV {t}")
                    continue
                ids.append(self.token2id[t])
            out.append(ids)
        return out

    def texts_to_token_ids(self, texts: List[str]) -> List[List[int]]:
        return self.tokens_to_token_ids(self.texts_to_tokens(texts))


class SimpleTokenizer(_TokenFileMixin):
    """Character tokenizer, no normalization (reference tokenizer.py:63-124)."""

    def __init__(self, token_file: Optional[str] = None):
        self._init_tokens(token_file)

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        return [list(t) for t in texts]


class EspeakTokenizer(_TokenFileMixin):
    """Espeak G2P for a fixed voice (reference tokenizer.py:127-198)."""

    def __init__(self, token_file: Optional[str] = None, lang: str = "en-us"):
        self.lang = lang
        self._init_tokens(token_file)

    def g2p(self, text: str) -> List[str]:
        try:
            tokens = phonemize_espeak(text, self.lang)
            return reduce(lambda x, y: x + y, tokens) if tokens else []
        except Exception as ex:
            logging.warning(f"Tokenization of {self.lang} texts failed: {ex}")
            return []

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        return [self.g2p(t) for t in texts]


class EmiliaTokenizer(_TokenFileMixin):
    """Bilingual zh/en phone tokenizer (reference tokenizer.py:201-499)."""

    def __init__(self, token_file: Optional[str] = None, token_type: str = "phone"):
        assert token_type == "phone", token_type
        self.english_normalizer = EnglishTextNormalizer()
        self.chinese_normalizer = ChineseTextNormalizer()
        self._init_tokens(token_file)

    # --- text preprocessing -------------------------------------------------

    def preprocess_text(self, text: str) -> str:
        return self.map_punctuations(text)

    @staticmethod
    def map_punctuations(text: str) -> str:
        pairs = [
            ("，", ","), ("。", "."), ("！", "!"), ("？", "?"), ("；", ";"),
            ("：", ":"), ("、", ","), ("‘", "'"), ("“", '"'), ("”", '"'),
            ("’", "'"), ("⋯", "…"), ("···", "…"), ("・・・", "…"), ("...", "…"),
        ]
        for a, b in pairs:
            text = text.replace(a, b)
        return text

    # --- language segmentation (reference tokenizer.py:387-473) -----------

    @staticmethod
    def is_chinese(char: str) -> bool:
        return "一" <= char <= "龥"

    @staticmethod
    def is_alphabet(char: str) -> bool:
        return ("A" <= char <= "Z") or ("a" <= char <= "z")

    @staticmethod
    def is_pinyin(part: str) -> bool:
        return part.startswith("<") and part.endswith(">")

    @staticmethod
    def is_tag(part: str) -> bool:
        return part.startswith("[") and part.endswith("]")

    def get_segment(self, text: str):
        parts = re.compile(r"[<[].*?[>\]]|.").findall(text)
        types = []
        for part in parts:
            if self.is_chinese(part) or self.is_pinyin(part):
                types.append("zh")
            elif self.is_alphabet(part):
                types.append("en")
            else:
                types.append("other")

        segments = []
        temp_seg, temp_lang = "", ""
        for i in range(len(types)):
            if i == 0:
                temp_seg, temp_lang = parts[i], types[i]
            elif temp_lang == "other":
                temp_seg += parts[i]
                temp_lang = types[i]
            elif types[i] in (temp_lang, "other"):
                temp_seg += parts[i]
            else:
                segments.append((temp_seg, temp_lang))
                temp_seg, temp_lang = parts[i], types[i]
        if parts:
            segments.append((temp_seg, temp_lang))
        return self.split_segments(segments)

    def split_segments(self, segments):
        result = []
        for temp_seg, temp_lang in segments:
            for part in re.split(r"([<[].*?[>\]])", temp_seg):
                if not part:
                    continue
                if self.is_pinyin(part):
                    result.append((part, "pinyin"))
                elif self.is_tag(part):
                    result.append((part, "tag"))
                else:
                    result.append((part, temp_lang))
        return result

    # --- per-language tokenization -----------------------------------------

    def tokenize_ZH(self, text: str) -> List[str]:
        try:
            text = self.chinese_normalizer.normalize(text)
            try:
                import jieba

                segs = list(jieba.cut(text))
            except ImportError:
                segs = [text]
            try:
                from pypinyin import Style, lazy_pinyin

                full = lazy_pinyin(
                    segs, style=Style.TONE3, tone_sandhi=True,
                    neutral_tone_with_five=True,
                )
            except ImportError:
                # self-contained pinyin fallback: word-level lexicon lookup
                # + the same word-based sandhi rules (frontend/zh_g2p.py);
                # extend with $ZIPVOICE_PINYIN_LEXICON (TSV or CC-CEDICT)
                from zipvoice_torch.frontend.zh_g2p import default_lexicon

                full = default_lexicon().g2p_words(segs)
            phones = []
            for x in full:
                if not (x[0:-1].isalpha() and x[-1] in "12345"):
                    phones.append(x)
                else:
                    phones.extend(split_pinyin(x))
            return phones
        except Exception as ex:
            logging.warning(f"Tokenization of Chinese texts failed: {ex}")
            return []

    def tokenize_EN(self, text: str) -> List[str]:
        try:
            text = self.english_normalizer.normalize(text)
            tokens = phonemize_espeak(text, "en-us")
            return reduce(lambda x, y: x + y, tokens) if tokens else []
        except Exception as ex:
            logging.warning(f"Tokenization of English texts failed: {ex}")
            return []

    def tokenize_pinyin(self, text: str) -> List[str]:
        assert text.startswith("<") and text.endswith(">")
        text = text.lstrip("<").rstrip(">")
        if not (text[0:-1].isalpha() and text[-1] in "12345"):
            logging.warning(f"<> should enclose pinyin, got: {text}; skipped")
            return []
        return split_pinyin(text)

    # --- public API ---------------------------------------------------------

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        texts = [self.preprocess_text(t) for t in texts]
        out = []
        for text in texts:
            phonemes: List[str] = []
            for seg, lang in self.get_segment(text):
                if lang == "zh":
                    phonemes += self.tokenize_ZH(seg)
                elif lang == "en":
                    phonemes += self.tokenize_EN(seg)
                elif lang == "pinyin":
                    phonemes += self.tokenize_pinyin(seg)
                elif lang == "tag":
                    phonemes += [seg]
                else:
                    logging.warning(f"skipping unknown-language segment {seg}")
            out.append(phonemes)
        return out


class DialogTokenizer(EmiliaTokenizer):
    """Adds [S1]/[S2] speaker-turn ids (reference tokenizer.py:502-515)."""

    def __init__(self, token_file: Optional[str] = None, token_type: str = "phone"):
        super().__init__(token_file=token_file, token_type=token_type)
        if token_file:
            self.spk_a_id = self.token2id["[S1]"]
            self.spk_b_id = self.token2id["[S2]"]

    def preprocess_text(self, text: str) -> str:
        text = re.sub(r"\s*(\[S[12]\])\s*", r"\1", text)
        return self.map_punctuations(text)


class LibriTTSTokenizer(_TokenFileMixin):
    """char/phone tokenizer with basic English cleaning
    (reference tokenizer.py:518-611; bpe mode omitted — no sentencepiece
    models ship with ZipVoice's released checkpoints)."""

    def __init__(self, token_file: Optional[str] = None, token_type: str = "char"):
        assert token_type in ("char", "phone"), token_type
        self.type = token_type
        self._en_norm = EnglishTextNormalizer()
        self._init_tokens(token_file)

    def normalize(self, text: str) -> str:
        # tacotron custom_english_cleaners: uppercase, expand numbers and
        # abbreviations, collapse whitespace
        text = self._en_norm.normalize(text)
        text = re.sub(r"\s+", " ", text).strip()
        return text.upper() if self.type == "char" else text

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        texts = [self.normalize(t) for t in texts]
        if self.type == "char":
            return [list(t) for t in texts]
        return [
            reduce(lambda x, y: x + y, phonemize_espeak(t.lower(), "en-us"), [])
            for t in texts
        ]


def get_tokenizer(name: str, token_file: Optional[str] = None, lang: str = "en-us"):
    """Registry mirroring reference add_tokens (tokenizer.py:614-627)."""
    if name == "emilia":
        return EmiliaTokenizer(token_file)
    if name == "espeak":
        return EspeakTokenizer(token_file, lang=lang)
    if name == "dialog":
        return DialogTokenizer(token_file)
    if name == "libritts":
        return LibriTTSTokenizer(token_file)
    if name == "simple":
        return SimpleTokenizer(token_file)
    raise ValueError(f"Unsupported tokenizer: {name}")
