"""First-party German grapheme-to-phoneme (espeak-ng de conventions;
the port's copy of ``zipvoice_tpu/frontend/de_g2p.py``).

Same role as frontend/es_g2p.py for the ``de`` voice: a real phoneme
stream when libespeak-ng is absent (the reference phonemizes every voice
with espeak, zipvoice/tokenizer/tokenizer.py:127-198), replacing the
char fallback.  German orthography is fairly regular; the engine covers:

- vowel length: long before single consonant + vowel / before h
  (Dehnungs-h) / doubled vowel / ie; short before consonant clusters and
  double consonants.
- umlauts ö/ü (øː/œ, yː/ʏ), diphthongs ei/ai -> aɪ, au -> aʊ,
  eu/äu -> ɔʏ.
- consonants: w -> v, v -> f, z -> ts, sch -> ʃ, initial st/sp -> ʃt/ʃp,
  ch -> ç after front vowels / x after back vowels, final -ig -> ɪç,
  s -> z before vowels, ß -> s, final devoicing b/d/g -> p/t/k,
  final -er -> ɐ, qu -> kv.
- stress: first syllable of the stem; the unstressed verbal/nominal
  prefixes be-, ge-, er-, ver-, zer-, ent-, emp-, miss- shift it right.

NOT espeak; differs on loanwords.  libespeak-ng is preferred when
importable (frontend/g2p.py).
"""

import re
import unicodedata
from typing import List

_CLAUSE_PUNCT = ".,;:!?"
_WORD_RE = re.compile(r"[a-zäöüßA-ZÄÖÜ]+")

IPA_VOWELS = {
    "a", "aː", "ɛ", "eː", "ɪ", "iː", "ɔ", "oː", "ʊ", "uː",
    "œ", "øː", "ʏ", "yː", "ə", "ɐ", "aɪ", "aʊ", "ɔʏ",
}
_FRONT = {"ɛ", "eː", "ɪ", "iː", "œ", "øː", "ʏ", "yː", "aɪ", "ɔʏ", "ə"}
_PREFIXES = ("be", "ge", "er", "ver", "zer", "ent", "emp", "miss")
_CONS = "bcdfghjklmnpqrstvwxzß"


def _normalize_word(w: str) -> str:
    w = w.lower()
    return "".join(
        c for c in unicodedata.normalize("NFC", w)
        if c.isalpha() or c in "äöüß"
    )


def _long_vowel(w: str, i: int) -> bool:
    """Is the single vowel at w[i] long?  Long before h, before a single
    consonant followed by a vowel, or word-final; short before clusters
    and doubled consonants."""
    n = len(w)
    if i + 1 >= n:
        return True
    c1 = w[i + 1]
    if c1 == "h":
        return True
    if c1 not in _CONS:
        return False  # vowel sequence handled as diphthong elsewhere
    if i + 2 >= n:
        return False  # vowel + final consonant: short (mit, an)
    c2 = w[i + 2]
    if c1 == c2:
        return False  # doubled consonant
    if c1 == "c" and c2 == "k":
        return False  # ck
    if c1 == "s" and c2 == "c":
        return False  # sch
    if c2 in _CONS:
        return False  # cluster
    return True


class GermanG2P:
    """EspeakG2P-interface German G2P."""

    def __init__(self, voice: str = "de"):
        if not voice.startswith("de"):
            raise ValueError(f"GermanG2P handles de voices, got {voice}")
        self.voice = voice

    def word_segments(self, word: str) -> List[str]:
        w = _normalize_word(word)
        if not w:
            return []
        segs: List[str] = []
        i = 0
        n = len(w)

        def last_front():
            for s_ in reversed(segs):
                if s_ in IPA_VOWELS:
                    return s_ in _FRONT
            return True

        while i < n:
            c = w[i]
            nxt = w[i + 1] if i + 1 < n else ""
            nxt2 = w[i + 2] if i + 2 < n else ""
            two = c + nxt
            # --- diphthongs / vowel digraphs
            if two in ("ei", "ai", "ey", "ay"):
                segs.append("aɪ")
                i += 2
            elif two == "au":
                segs.append("aʊ")
                i += 2
            elif two in ("eu", "äu"):
                segs.append("ɔʏ")
                i += 2
            elif two == "ie" and not (i + 2 < n and w[i + 2] in "aeiou"):
                segs.append("iː")
                i += 2
            elif two in ("aa", "ee", "oo"):
                segs.append({"a": "aː", "e": "eː", "o": "oː"}[c])
                i += 2
            # --- single vowels
            elif c == "a":
                segs.append("aː" if _long_vowel(w, i) else "a")
                i += 1 + (nxt == "h")
            elif c == "e":
                if (i > 0) and (i == n - 1 or (
                        i == n - 2 and w[-1] in "nlst")):
                    segs.append("ə")  # final/reduced e
                    i += 1
                elif i + 1 < n and nxt == "r" and i + 2 == n:
                    segs.append("ɐ")  # -er final
                    i += 2
                else:
                    segs.append("eː" if _long_vowel(w, i) else "ɛ")
                    i += 1 + (nxt == "h")
            elif c == "i":
                segs.append("iː" if _long_vowel(w, i) else "ɪ")
                i += 1 + (nxt == "h")
            elif c == "o":
                segs.append("oː" if _long_vowel(w, i) else "ɔ")
                i += 1 + (nxt == "h")
            elif c == "u":
                segs.append("uː" if _long_vowel(w, i) else "ʊ")
                i += 1 + (nxt == "h")
            elif c == "ä":
                segs.append("ɛː" if _long_vowel(w, i) else "ɛ")
                i += 1 + (nxt == "h")
            elif c == "ö":
                segs.append("øː" if _long_vowel(w, i) else "œ")
                i += 1 + (nxt == "h")
            elif c == "ü":
                segs.append("yː" if _long_vowel(w, i) else "ʏ")
                i += 1 + (nxt == "h")
            elif c == "y":
                segs.append("yː" if _long_vowel(w, i) else "ʏ")
                i += 1
            # --- consonant digraphs
            elif c + nxt + nxt2 == "sch":
                segs.append("ʃ")
                i += 3
            elif two == "ch":
                if nxt2 == "s":
                    segs.extend(("k", "s"))  # chs -> ks (Fuchs)
                    i += 3
                else:
                    segs.append("ç" if last_front() else "x")
                    i += 2
            elif two == "ck":
                segs.append("k")
                i += 2
            elif (c == nxt and c in "bdfgklmnprst"):
                # doubled consonant: one sound (hallo, Wasser shortness is
                # already decided by _long_vowel)
                i += 1  # fall through next iteration handles the single
                continue
            elif two == "tz":
                segs.extend(("t", "s"))
                i += 2
            elif two == "qu":
                segs.extend(("k", "v"))
                i += 2
            elif two == "ph":
                segs.append("f")
                i += 2
            elif two == "th":
                segs.append("t")
                i += 2
            elif two == "ng":
                segs.append("ŋ")
                i += 2
            elif two in ("sp", "st") and i == 0:
                segs.extend(("ʃ", {"p": "p", "t": "t"}[nxt]))
                i += 2
            # --- single consonants
            elif c == "b":
                segs.append("p" if i + 1 == n else "b")
                i += 1
            elif c == "d":
                segs.append("t" if i + 1 == n else "d")
                i += 1
            elif c == "g":
                if i + 1 == n and i >= 1 and w[i - 1] == "i":
                    segs.append("ç")  # -ig
                elif i + 1 == n:
                    segs.append("k")
                else:
                    segs.append("ɡ")
                i += 1
            elif c == "s":
                if i + 1 < n and w[i + 1] in "aeiouäöüy" and (
                        i == 0 or w[i - 1] in "aeiouäöüylmnr"):
                    segs.append("z")
                else:
                    segs.append("s")
                i += 1
            elif c == "ß":
                segs.append("s")
                i += 1
            elif c == "v":
                segs.append("f")
                i += 1
            elif c == "w":
                segs.append("v")
                i += 1
            elif c == "z":
                segs.extend(("t", "s"))
                i += 1
            elif c == "j":
                segs.append("j")
                i += 1
            elif c == "r":
                # vocalized after a long vowel at coda end (espeak ɐ offglide
                # folded into ɐ for -er already); keep ʁ elsewhere
                segs.append("ʁ")
                i += 1
            elif c == "c":
                segs.append("k")
                i += 1
            elif c == "x":
                segs.extend(("k", "s"))
                i += 1
            elif c == "h":
                # lengthening h after a vowel was consumed with the vowel;
                # an h reaching here starts a syllable: pronounce it
                segs.append("h")
                i += 1
            elif c in "fklmnpt":
                segs.append(c)
                i += 1
            else:
                i += 1

        # --- stress -------------------------------------------------------
        nuclei = [k for k, s_ in enumerate(segs) if s_ in IPA_VOWELS
                  or s_ == "ɛː"]
        if not nuclei:
            return segs
        target = nuclei[0]
        for pre in _PREFIXES:
            if (w.startswith(pre) and len(w) > len(pre) + 2
                    and len(nuclei) >= 2):
                # unstressed prefix: stress the next syllable; be-/ge-
                # reduce their vowel to schwa (gemacht -> ɡəmˈaxt)
                target = nuclei[1]
                if pre in ("be", "ge") and segs[nuclei[0]] in ("eː", "ɛ"):
                    segs[nuclei[0]] = "ə"
                break
        if segs[target] == "ə" and len(nuclei) >= 2:
            target = nuclei[nuclei.index(target) + 1]
        segs = list(segs)
        segs[target] = "ˈ" + segs[target]
        return segs

    def word_to_ipa(self, word: str) -> str:
        return "".join(self.word_segments(word))

    def phonemize(self, text: str) -> List[List[str]]:
        out: List[List[str]] = []
        for clause, punct in _split_clauses(text):
            ipa_words = [
                self.word_to_ipa(m.group(0))
                for m in _WORD_RE.finditer(clause)
            ]
            ipa_words = [x for x in ipa_words if x]
            phones = list(" ".join(ipa_words))
            if punct:
                phones.append(punct)
            if phones:
                out.append(phones)
        return out


def _split_clauses(text: str):
    parts = re.split(r"([" + re.escape(_CLAUSE_PUNCT) + r"])", text)
    out = []
    for i in range(0, len(parts), 2):
        clause = parts[i].strip()
        punct = parts[i + 1] if i + 1 < len(parts) else ""
        if clause or punct:
            out.append((clause, punct))
    return out
