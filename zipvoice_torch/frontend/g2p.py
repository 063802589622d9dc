"""Grapheme-to-phoneme backends (the port's copy of
``zipvoice_tpu/frontend/g2p.py``).

The reference uses piper-phonemize, a C++ wrapper around espeak-ng
(reference zipvoice/tokenizer/tokenizer.py:32-39).  Here the binding to
libespeak-ng is done directly with ctypes (no extension build needed):
``espeak_TextToPhonemes`` in IPA mode, clause by clause, reproducing
piper-phonemize's output structure (a list of phoneme lists, one per clause,
with the clause-terminating punctuation appended as its own token).

When libespeak-ng is not installed, ``EspeakG2P`` raises at construction
and ``get_g2p`` takes the first-party English G2P for en-* voices, or a
clearly-flagged character-level G2P for voices with no first-party G2P.
"""

import ctypes
import ctypes.util
import re
from typing import List, Optional

_CLAUSE_PUNCT = ".,;:!?"


class EspeakG2P:
    """ctypes binding to espeak-ng's phonemizer (IPA output)."""

    AUDIO_OUTPUT_SYNCHRONOUS = 0x02
    espeakCHARS_UTF8 = 1
    espeakPHONEMES_IPA = 0x02

    _lib = None

    def __init__(self, voice: str = "en-us"):
        lib = self._load()
        if lib is None:
            raise RuntimeError(
                "libespeak-ng not found; install espeak-ng or use a "
                "character-level tokenizer"
            )
        self.voice = voice
        rate = lib.espeak_Initialize(self.AUDIO_OUTPUT_SYNCHRONOUS, 0, None, 0)
        if rate <= 0:
            raise RuntimeError("espeak_Initialize failed")
        lib.espeak_SetVoiceByName(voice.encode())
        self._libref = lib

    @classmethod
    def _load(cls):
        if cls._lib is not None:
            return cls._lib
        for name in ("espeak-ng", "espeak"):
            path = ctypes.util.find_library(name)
            if path:
                lib = ctypes.cdll.LoadLibrary(path)
                lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
                lib.espeak_TextToPhonemes.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.c_int,
                    ctypes.c_int,
                ]
                cls._lib = lib
                return lib
        return None

    def phonemize(self, text: str) -> List[List[str]]:
        """text -> list of per-clause phoneme (character) lists, piper-style."""
        clauses = _split_clauses(text)
        out = []
        for clause, punct in clauses:
            buf = ctypes.c_char_p(clause.encode("utf-8"))
            ptr = ctypes.cast(
                ctypes.pointer(buf), ctypes.POINTER(ctypes.c_void_p)
            )
            phonemes: List[str] = []
            while ptr.contents.value:
                res = self._libref.espeak_TextToPhonemes(
                    ptr, self.espeakCHARS_UTF8, self.espeakPHONEMES_IPA
                )
                if res:
                    phonemes.extend(list(res.decode("utf-8").strip()))
            if punct:
                phonemes.append(punct)
            if phonemes:
                out.append(phonemes)
        return out


class CharG2P:
    """Fallback 'G2P': characters as phonemes (lowercased)."""

    def __init__(self, voice: str = "en-us"):
        self.voice = voice

    def phonemize(self, text: str) -> List[List[str]]:
        return [list(text)]


def _split_clauses(text: str):
    parts = re.split(r"([" + re.escape(_CLAUSE_PUNCT) + r"])", text)
    out = []
    for i in range(0, len(parts), 2):
        clause = parts[i].strip()
        punct = parts[i + 1] if i + 1 < len(parts) else ""
        if clause or punct:
            out.append((clause, punct))
    return out


_BACKEND_CACHE = {}

# first-party G2Ps of the JAX package that the port has not carried over
# yet; a voice of these languages raises rather than falling to CharG2P,
# whose ids would differ from the JAX package's
_UNPORTED_LANGUAGES = ("es", "de", "it", "ru", "nl", "pl", "pt", "fr")


def get_g2p(voice: str = "en-us"):
    """Backend selection: libespeak-ng when present; else the first-party
    English G2P (frontend/en_g2p.py) for en-* voices; CharG2P for voices
    with no first-party G2P.  Voices of the eight other first-party
    languages raise ``NotImplementedError`` until ROADMAP item A3b ports
    their G2Ps."""
    if voice in _BACKEND_CACHE:
        return _BACKEND_CACHE[voice]
    try:
        backend = EspeakG2P(voice)
    except (RuntimeError, OSError):
        import logging

        if voice.startswith("en"):
            from zipvoice_torch.frontend.en_g2p import EnglishG2P

            logging.info(
                "libespeak-ng unavailable; using the first-party English "
                "G2P (espeak-convention IPA; see frontend/en_g2p.py)"
            )
            backend = EnglishG2P(voice)
        elif voice.startswith(_UNPORTED_LANGUAGES):
            raise NotImplementedError(
                f"libespeak-ng unavailable and the first-party G2P for "
                f"voice {voice} is not ported to zipvoice_torch yet "
                "(ROADMAP A3b: the es, de, it, ru, nl, pl, pt and fr G2P)"
            )
        else:
            logging.warning(
                f"libespeak-ng unavailable and no first-party G2P for "
                f"voice {voice}; falling back to character-level G2P "
                "(phoneme token ids will NOT match reference checkpoints)"
            )
            backend = CharG2P(voice)
    _BACKEND_CACHE[voice] = backend
    return backend


def espeak_available(voice: str = "en-us") -> bool:
    """True when the real libespeak-ng binding is usable (the token-fixture
    tests gate real-espeak cases on this)."""
    return isinstance(get_g2p(voice), EspeakG2P)


def phonemize_espeak(text: str, voice: str) -> List[List[str]]:
    """Drop-in equivalent of piper_phonemize.phonemize_espeak."""
    return get_g2p(voice).phonemize(text)
