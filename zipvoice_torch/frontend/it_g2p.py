"""First-party Italian grapheme-to-phoneme (espeak-ng it conventions;
the port's copy of ``zipvoice_tpu/frontend/it_g2p.py``).

Same role as frontend/es_g2p.py for the ``it`` voice.  Italian
orthography is close to phonemic:

- c/g soften before e,i (tʃ/dʒ); ch/gh harden them back (k/ɡ);
  ci/gi + vowel are the soft consonant with silent i (ciao -> tʃao).
- gli -> ʎ, gn -> ɲ, sc+e/i -> ʃ, z -> ts (dz word-initially),
  s between vowels -> z, qu -> kw, h silent.
- stress: accented finals win (città); else penultimate (the dominant
  pattern espeak defaults to without its exception lexicon — sdrucciole
  words are the known divergence, documented).

NOT espeak; differs on irregular-stress words and loanwords.
libespeak-ng is preferred when importable (frontend/g2p.py).
"""

import re
import unicodedata
from typing import List

_CLAUSE_PUNCT = ".,;:!?"
_WORD_RE = re.compile(r"[a-zàèéìòóùA-ZÀÈÉÌÒÓÙ]+")

IPA_VOWELS = {"a", "e", "ɛ", "i", "o", "ɔ", "u"}
_ACCENTED = {"à": "a", "è": "ɛ", "é": "e", "ì": "i", "ò": "ɔ",
             "ó": "o", "ù": "u"}


def _normalize_word(w: str) -> str:
    w = w.lower()
    return "".join(
        c for c in unicodedata.normalize("NFC", w)
        if c.isalpha() or c in "àèéìòóù"
    )


class ItalianG2P:
    """EspeakG2P-interface Italian G2P."""

    def __init__(self, voice: str = "it"):
        if not voice.startswith("it"):
            raise ValueError(f"ItalianG2P handles it voices, got {voice}")
        self.voice = voice

    def word_segments(self, word: str) -> List[str]:
        w = _normalize_word(word)
        if not w:
            return []
        segs: List[str] = []
        accent_idx = None
        i = 0
        n = len(w)

        def prev_is_vowel():
            return bool(segs) and segs[-1] in IPA_VOWELS

        while i < n:
            c = w[i]
            nxt = w[i + 1] if i + 1 < n else ""
            nxt2 = w[i + 2] if i + 2 < n else ""
            if c in _ACCENTED:
                segs.append(_ACCENTED[c])
                accent_idx = len(segs) - 1
                i += 1
            elif c in "aeiou":
                segs.append(c)
                i += 1
            elif c == "c":
                if nxt == "c":
                    # geminate: espeak writes doubled stops/affricates
                    # (gnocchi -> ɲˈokki, faccia -> fˈattʃa)
                    n3 = w[i + 2] if i + 2 < n else ""
                    n4 = w[i + 3] if i + 3 < n else ""
                    if n3 == "h":
                        segs.extend(("k", "k"))
                        i += 3
                    elif n3 == "i" and n4 and n4 in "aeou":
                        segs.extend(("t", "tʃ"))
                        i += 3
                    elif n3 and n3 in "ei":
                        segs.extend(("t", "tʃ"))
                        i += 2
                    else:
                        segs.extend(("k", "k"))
                        i += 2
                elif nxt == "h":
                    segs.append("k")
                    i += 2
                elif nxt == "i" and nxt2 and nxt2 in "aeou":
                    segs.append("tʃ")  # silent i (ciao)
                    i += 2
                elif nxt and nxt in "ei":
                    segs.append("tʃ")
                    i += 1
                else:
                    segs.append("k")
                    i += 1
            elif c == "g":
                if nxt == "g":
                    n3 = w[i + 2] if i + 2 < n else ""
                    n4 = w[i + 3] if i + 3 < n else ""
                    if n3 == "h":
                        segs.extend(("ɡ", "ɡ"))
                        i += 3
                    elif n3 == "i" and n4 and n4 in "aeou":
                        segs.extend(("d", "dʒ"))
                        i += 3
                    elif n3 and n3 in "ei":
                        segs.extend(("d", "dʒ"))
                        i += 2
                    else:
                        segs.extend(("ɡ", "ɡ"))
                        i += 2
                elif nxt == "h":
                    segs.append("ɡ")
                    i += 2
                elif nxt == "l" and nxt2 == "i":
                    segs.append("ʎ")
                    i += 3 if not (i + 3 < n and w[i + 3] in "aeou") else 3
                elif nxt == "n":
                    segs.append("ɲ")
                    i += 2
                elif nxt == "i" and nxt2 and nxt2 in "aeou":
                    segs.append("dʒ")  # silent i (giorno)
                    i += 2
                elif nxt and nxt in "ei":
                    segs.append("dʒ")
                    i += 1
                else:
                    segs.append("ɡ")
                    i += 1
            elif c == "s":
                if nxt == "c" and (nxt2 and nxt2 in "ei" or (
                        nxt2 == "i" )):
                    segs.append("ʃ")
                    # sci+vowel: silent i
                    if nxt2 == "i" and i + 3 < n and w[i + 3] in "aeou":
                        i += 3
                    else:
                        i += 2
                elif prev_is_vowel() and nxt and nxt in "aeiou":
                    segs.append("z")
                    i += 1
                elif nxt and nxt in "bdglmnrv":
                    segs.append("z")  # voiced before voiced consonant
                    i += 1
                else:
                    segs.append("s")
                    i += 1
            elif c == "z":
                if nxt == "z":
                    segs.extend(("t", "t", "s"))  # pizza -> pˈittsa
                    i += 2
                else:
                    segs.extend(("d", "z") if i == 0 else ("t", "s"))
                    i += 1
            elif c == "q":
                segs.extend(("k", "w"))
                i += 2 if nxt == "u" else 1
            elif c == "h":
                i += 1  # silent
            elif c == "r":
                segs.append("r")
                i += 1
            elif c == "v":
                segs.append("v")
                i += 1
            elif c in "bdflmnprtv":
                # geminates kept doubled (bello -> bˈello)
                segs.append(c)
                i += 1
            elif c == "k":
                segs.append("k")
                i += 1
            elif c == "w":
                segs.append("w")
                i += 1
            elif c == "x":
                segs.extend(("k", "s"))
                i += 1
            elif c == "j":
                segs.append("j")
                i += 1
            elif c == "y":
                segs.append("j")
                i += 1
            else:
                i += 1

        # glides: unaccented i/u before a vowel (piano -> pjano,
        # buono -> bwɔno)
        for k in range(len(segs) - 1):
            if k == accent_idx:
                continue
            if segs[k] == "i" and segs[k + 1] in IPA_VOWELS:
                segs[k] = "j"
            elif segs[k] == "u" and segs[k + 1] in IPA_VOWELS:
                segs[k] = "w"

        nuclei = [k for k, s_ in enumerate(segs) if s_ in IPA_VOWELS]
        if not nuclei:
            return segs
        if accent_idx is not None:
            target = min(nuclei, key=lambda k: abs(k - accent_idx))
        elif len(nuclei) == 1:
            target = nuclei[0]
        else:
            target = nuclei[-2]  # penultimate default
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
