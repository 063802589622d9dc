"""First-party Dutch grapheme-to-phoneme (espeak-ng nl conventions;
the port's copy of ``zipvoice_tpu/frontend/nl_g2p.py``).

The reference phonemizes every voice with piper-phonemize/espeak-ng
(reference zipvoice/tokenizer/tokenizer.py:127-198).  Offline, voices
without a first-party engine fall back to character G2P; this module
gives Dutch a real phoneme stream:

- vowel digraphs: aa->aː, ee->eː, oo->oː, uu->y, ie->i, oe->u, eu->øː,
  ij/ei->ɛi, ui->œy, ou/au->ʌu, aai->aːj, ooi->oːj, eeuw->eːw,
  ieuw->iw.
- open-syllable lengthening: a/e/o/u followed by ONE consonant + a
  vowel read long (water -> ʋaːtər); closed syllables stay short
  (ɑ ɛ ɪ ɔ ʏ).
- schwa: final -e and the unstressed prefixes be-/ge-/ver-/ont-/her-
  (which also shift stress to the root syllable); -en final -> ən.
- consonants: g/ch->x, sch->sx (word-final -isch->is), w->ʋ, ng->ŋ,
  final b/d/v/z devoice (p t f s).
- stress: first syllable, unless an unstressed prefix moves it right.

Like frontend/en_g2p.py this is NOT espeak and may differ on loanwords;
libespeak-ng is always preferred when importable (frontend/g2p.py).
"""

import re
import unicodedata
from typing import List

_CLAUSE_PUNCT = ".,;:!?"
_WORD_RE = re.compile(r"[a-zëéèêïöüA-ZËÉÈÊÏÖÜ]+")

_LONG = {"a": "aː", "e": "eː", "o": "oː", "u": "y"}
_SHORT = {"a": "ɑ", "e": "ɛ", "i": "ɪ", "o": "ɔ", "u": "ʏ"}
IPA_VOWELS = {"a", "ɑ", "e", "ɛ", "ə", "i", "ɪ", "o", "ɔ", "u",
              "y", "ʏ", "ø", "œ", "ʌ"}
_PREFIXES = ("be", "ge", "ver", "ont", "her", "er")

_DEVOICE_FINAL = {"b": "p", "d": "t", "v": "f", "z": "s"}

# schwa-vowel function words (articles/pronouns/particles) that the
# syllable rules would otherwise read with a full vowel
_FUNCTION_WORDS = {
    "de": "də", "het": "ət", "een": "ən", "je": "jə", "ze": "zə",
    "we": "ʋə", "me": "mə", "te": "tə", "er": "ər",
}


def _normalize_word(w: str) -> str:
    w = w.lower()
    nfd = unicodedata.normalize("NFD", w)
    return "".join(c for c in nfd if c.isalpha())


def _is_vowel_letter(c: str) -> bool:
    return c in "aeiou" or c == "y"


class DutchG2P:
    """EspeakG2P-interface Dutch G2P: phonemize(text) -> per-clause
    codepoint lists with the clause punctuation appended."""

    def __init__(self, voice: str = "nl"):
        if not voice.startswith("nl"):
            raise ValueError(f"DutchG2P handles nl voices, got {voice}")
        self.voice = voice

    # --- single word -> IPA segments ------------------------------------

    def word_segments(self, word: str) -> List[str]:
        w = _normalize_word(word)
        if not w:
            return []
        if w in _FUNCTION_WORDS:
            return list(_FUNCTION_WORDS[w])
        segs: List[str] = []
        i = 0
        n = len(w)

        def push(seg):
            segs.append(seg)

        while i < n:
            c = w[i]
            nxt = w[i + 1] if i + 1 < n else ""
            nxt2 = w[i + 2] if i + 2 < n else ""
            nxt3 = w[i + 3] if i + 3 < n else ""
            if c == "e" and nxt == "e" and nxt2 == "u" and nxt3 == "w":
                push("eː"); push("w"); i += 4
            elif c == "i" and nxt == "e" and nxt2 == "u" and nxt3 == "w":
                push("i"); push("w"); i += 4
            elif c == "a" and nxt == "a" and nxt2 == "i":
                push("aː"); push("j"); i += 3
            elif c == "o" and nxt == "o" and nxt2 == "i":
                push("oː"); push("j"); i += 3
            elif c in "aeou" and nxt == c:
                # doubled vowel: always long
                push(_LONG[c]); i += 2
            elif c == "i" and nxt == "e":
                push("i"); i += 2
            elif c == "o" and nxt == "e":
                push("u"); i += 2
            elif c == "e" and nxt == "u":
                push("øː"); i += 2
            elif (c == "i" and nxt == "j") or (c == "e" and nxt == "i"):
                push("ɛ"); push("i"); i += 2
            elif c == "u" and nxt == "i":
                push("œ"); push("y"); i += 2
            elif (c == "o" and nxt == "u") or (c == "a" and nxt == "u"):
                push("ʌ"); push("u")
                i += 3 if nxt2 == "w" else 2  # vrouw: -ouw silent w
            elif c in "aeiou":
                # single vowel letter: long in an open syllable
                # (exactly one consonant then a vowel), else short;
                # final/unstressed e handled in the schwa pass below
                has_nucleus = any(
                    s_[0] in IPA_VOWELS for s_ in segs
                )
                if c == "e" and i + 1 == n and has_nucleus:
                    push("ə")
                elif (c == "e" and nxt and nxt in "nrlm"
                      and i + 2 == n and has_nucleus):
                    push("ə")  # unstressed final -en/-er/-el/-em
                elif (nxt and not _is_vowel_letter(nxt)
                      and nxt2 and _is_vowel_letter(nxt2)
                      and c != "i"):
                    if c == "e" and has_nucleus:
                        # non-initial open-syllable e is usually the
                        # linking schwa (goedemorgen -> xudəmɔrxən)
                        push("ə")
                    else:
                        push(_LONG[c])
                elif c == "i":
                    push("ɪ")
                else:
                    push(_SHORT[c])
                i += 1
            elif c == "s" and nxt == "c" and nxt2 == "h":
                if i + 3 == n and i >= 1 and w[i - 1] == "i":
                    push("s")  # -isch: ch silent (historisch -> ...ris)
                    i += 3
                else:
                    push("s"); push("x"); i += 3
            elif c == "c" and nxt == "h":
                push("x"); i += 2
            elif c == "g":
                push("x"); i += 1
            elif c == "n" and nxt == "g":
                push("ŋ"); i += 2
            elif c == "w":
                push("ʋ"); i += 1
            elif c == "j":
                push("j"); i += 1
            elif c == "y":
                push("j" if (nxt and _is_vowel_letter(nxt)) else "i")
                i += 1
            elif c == "c":
                push("s" if (nxt and nxt in "ei") else "k"); i += 1
            elif c == "q":
                push("k")
                if nxt == "u":
                    push("ʋ"); i += 1
                i += 1
            elif c == "x":
                push("k"); push("s"); i += 1
            elif c in "bdfhklmnprstvz":
                push(c)
                i += 2 if nxt == c else 1  # degemination (gezellig)
            else:
                i += 1

        # --- final devoicing --------------------------------------------
        if segs and segs[-1] in _DEVOICE_FINAL:
            segs[-1] = _DEVOICE_FINAL[segs[-1]]

        # --- stress + prefix schwa --------------------------------------
        nuclei = [
            k for k, s_ in enumerate(segs)
            if s_[0] in IPA_VOWELS and s_ not in ("j", "ʋ", "w")
            # diphthong tails (ɛi, œy, ʌu) are not their own nuclei
            and not (k > 0 and s_ in ("i", "y", "u")
                     and segs[k - 1] in ("ɛ", "œ", "ʌ"))
        ]
        if not nuclei:
            return segs
        target_idx = 0
        for p in _PREFIXES:
            if w.startswith(p) and len(nuclei) >= 2 and len(w) > len(p) + 2:
                target_idx = 1
                # the prefix vowel reduces to schwa (be-/ge-/ver-/her-)
                if p in ("be", "ge", "ver", "her", "er"):
                    segs[nuclei[0]] = "ə"
                break
        target = nuclei[target_idx]
        # unstressed final single-e already ə; also -en -> ən
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
