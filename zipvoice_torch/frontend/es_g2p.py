"""First-party Spanish grapheme-to-phoneme (espeak-ng es conventions;
the port's copy of ``zipvoice_tpu/frontend/es_g2p.py``).

The reference phonemizes every voice with piper-phonemize/espeak-ng
(reference zipvoice/tokenizer/tokenizer.py:127-198).  Offline, non-en/zh
voices previously fell back to character G2P (frontend/g2p.py); this
module gives Spanish a real phoneme stream.  Spanish orthography is
nearly phonemic, so a rule engine covers it closely:

- voices: ``es`` (Castilian: c/z before e,i -> θ, ll -> ʎ) and
  ``es-419``/``es-mx`` (Latin American: seseo c/z -> s, yeísmo ll -> ʝ).
- espeak-style IPA: tap ``ɾ`` vs trill ``r``, ``ɲ``, ``tʃ``, ``x``,
  ``ʝ``, approximant lenition of b/d/g between vowels (``β``/``ð``/
  ``ɣ``), stress mark ``ˈ`` immediately before the stressed vowel.
- stress: acute accent wins; else penultimate for vowel/n/s-final words,
  final otherwise (the standard rule espeak implements).

Like frontend/en_g2p.py this is NOT espeak and may differ on loanwords;
libespeak-ng is always preferred when importable (frontend/g2p.py).
"""

import re
import unicodedata
from typing import List

_VOWELS = "aeiouáéíóú"
_STRONG = "aeoáéó"
_ACCENTED = {"á": "a", "é": "e", "í": "i", "ó": "o", "ú": "u"}

_CLAUSE_PUNCT = ".,;:!?"
_WORD_RE = re.compile(r"[a-záéíóúüñA-ZÁÉÍÓÚÜÑ]+")

# segments the engine emits (single phonemes; multi-codepoint kept whole)
IPA_VOWELS = {"a", "e", "i", "o", "u"}


def _normalize_word(w: str) -> str:
    w = w.lower()
    # keep ñ/ü/accents; drop other diacritics
    return "".join(
        c for c in unicodedata.normalize("NFC", w)
        if c.isalpha() or c in "áéíóúüñ"
    )


def _glide_pass(segs: List[str], accent_idx):
    """espeak writes rising diphthongs with glides: i+V -> jV (gracias ->
    ɡɾˈaθjas, ciudad -> θjuðˈað), u+(a,e,o) -> wV (agua -> ˈaɣwa).
    Falling diphthongs keep the weak vowel (aire, muy -> mˈui, fui ->
    fˈui).  An ACCENTED weak vowel is always a nucleus (día -> dˈia
    hiatus), never a glide."""
    out = list(segs)
    for k in range(len(out) - 1):
        if k == accent_idx:
            continue
        nxt = out[k + 1]
        if out[k] == "i" and nxt in IPA_VOWELS and nxt != "i":
            out[k] = "j"
        elif out[k] == "u" and nxt in ("a", "e", "o"):
            out[k] = "w"
    return out


def _syllable_nuclei(segs: List[str]) -> List[int]:
    """Indices of vowel nuclei after the glide pass: every vowel except a
    weak i/u riding the tail of a falling diphthong (vowel + i/u)."""
    nuclei = []
    for k, s_ in enumerate(segs):
        if s_ not in IPA_VOWELS:
            continue
        if (s_ in "iu" and k > 0 and segs[k - 1] in IPA_VOWELS):
            continue  # falling-diphthong tail
        nuclei.append(k)
    return nuclei


class SpanishG2P:
    """EspeakG2P-interface Spanish G2P: phonemize(text) ->
    per-clause codepoint lists with the clause punctuation appended."""

    def __init__(self, voice: str = "es"):
        if not voice.startswith("es"):
            raise ValueError(f"SpanishG2P handles es voices, got {voice}")
        self.voice = voice
        # seseo + yeísmo for Latin American voices
        self.latam = voice not in ("es", "es-es")

    # --- single word -> IPA segments ------------------------------------

    def word_segments(self, word: str) -> List[str]:
        w = _normalize_word(word)
        if not w:
            return []
        th = "s" if self.latam else "θ"
        ll = "ʝ" if self.latam else "ʎ"
        segs: List[str] = []
        stressed_letter = None  # index into segs of the accented vowel
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
                stressed_letter = len(segs) - 1
                i += 1
            elif c in "aeio":
                segs.append(c)
                i += 1
            elif c == "u":
                segs.append("u")
                i += 1
            elif c == "ü":
                segs.append("w")
                i += 1
            elif c == "c":
                if nxt and nxt in "eiéí":
                    segs.append(th)
                elif nxt == "h":
                    segs.append("tʃ")
                    i += 1
                else:
                    segs.append("k")
                i += 1
            elif c == "g":
                if nxt and nxt in "eiéí":
                    segs.append("x")
                elif nxt == "u" and nxt2 and nxt2 in "eiéí":
                    # gue/gui: silent u
                    segs.append("ɣ" if prev_is_vowel() else "ɡ")
                    i += 1
                else:
                    segs.append("ɣ" if prev_is_vowel() else "ɡ")
                i += 1
            elif c == "q":
                segs.append("k")
                if nxt == "u":
                    i += 1
                i += 1
            elif c == "b" or c == "v":
                segs.append("β" if prev_is_vowel() else "b")
                i += 1
            elif c == "d":
                segs.append("ð" if prev_is_vowel() else "d")
                i += 1
            elif c == "h":
                i += 1  # silent
            elif c == "j":
                segs.append("x")
                i += 1
            elif c == "l":
                if nxt == "l":
                    segs.append(ll)
                    i += 2
                else:
                    segs.append("l")
                    i += 1
            elif c == "n":
                segs.append("n")
                i += 1
            elif c == "ñ":
                segs.append("ɲ")
                i += 1
            elif c == "r":
                if nxt == "r":
                    segs.append("r")
                    i += 2
                elif not segs or segs[-1] in ("n", "l", "s"):
                    segs.append("r")  # word-initial / after n,l,s: trill
                    i += 1
                else:
                    segs.append("ɾ")
                    i += 1
            elif c == "y":
                if i == n - 1 and (i == 0 or w[i - 1] not in _VOWELS):
                    segs.append("i")  # "y" alone / muy-final
                elif i == n - 1:
                    segs.append("i")
                else:
                    segs.append("ʝ")
                i += 1
            elif c == "z":
                segs.append(th)
                i += 1
            elif c == "x":
                segs.extend(("k", "s"))
                i += 1
            elif c == "w":
                segs.append("w")
                i += 1
            elif c == "k":
                segs.append("k")
                i += 1
            elif c in "fmpst":
                segs.append(c)
                i += 1
            else:
                i += 1  # unknown letter: skip

        # --- stress assignment ------------------------------------------
        segs = _glide_pass(segs, stressed_letter)
        nuclei = _syllable_nuclei(segs)
        if not nuclei:
            return segs
        if stressed_letter is not None:
            # accent wins; snap to the nucleus containing that vowel
            target = min(nuclei, key=lambda k: abs(k - stressed_letter))
        elif len(nuclei) == 1:
            target = nuclei[0]
        elif w[-1] in "aeiouns" or w[-1] in _ACCENTED:
            target = nuclei[-2]
        else:
            target = nuclei[-1]
        segs = list(segs)
        segs[target] = "ˈ" + segs[target]
        return segs

    def word_to_ipa(self, word: str) -> str:
        return "".join(self.word_segments(word))

    # --- EspeakG2P interface --------------------------------------------

    def phonemize(self, text: str) -> List[List[str]]:
        out: List[List[str]] = []
        for clause, punct in _split_clauses(text):
            ipa_words = [
                self.word_to_ipa(m.group(0))
                for m in _WORD_RE.finditer(clause)
            ]
            ipa_words = [w for w in ipa_words if w]
            phones = list(" ".join(ipa_words))
            if punct:
                phones.append(punct)
            if phones:
                out.append(phones)
        return out


def _split_clauses(text: str):
    parts = re.split(r"([" + re.escape(_CLAUSE_PUNCT) + r"¡¿])", text)
    out = []
    for i in range(0, len(parts), 2):
        clause = parts[i].strip()
        punct = parts[i + 1] if i + 1 < len(parts) else ""
        if punct in "¡¿":
            punct = ""  # inverted marks open a clause, they don't end one
        if clause or punct:
            out.append((clause, punct))
    return out
