"""First-party Portuguese grapheme-to-phoneme (espeak-ng pt conventions;
the port's copy of ``zipvoice_tpu/frontend/pt_g2p.py``).

The reference phonemizes every voice with piper-phonemize/espeak-ng
(reference zipvoice/tokenizer/tokenizer.py:127-198).  Offline, voices
without a first-party engine fall back to character G2P (frontend/
g2p.py); this module gives Portuguese a real phoneme stream:

- voices: ``pt``/``pt-pt`` (European: pretonic vowel reduction a->ɐ,
  o->u, final e->ɨ; coda s->ʃ) and ``pt-br`` (Brazilian: t/d->tʃ/dʒ
  before i, coda l->w, coda s stays s).
- nasal vowels: ã/õ and V+m/n in coda -> ɐ̃ ẽ ĩ õ ũ (the combining
  tilde is its own codepoint, matching espeak's output where the
  tokenizer treats each codepoint as a token); ão -> ɐ̃w, ãe -> ɐ̃j,
  õe -> õj.
- consonants: nh->ɲ, lh->ʎ, ch/x->ʃ, c(e,i)->s, ç->s, g(e,i)->ʒ,
  j->ʒ, intervocalic s->z, rr/initial r->ʁ, single r->ɾ.
- stress: written accent wins; else penultimate for words ending in
  a/e/o(+s) or -am/-em, final otherwise.

Like frontend/en_g2p.py this is NOT espeak and may differ on loanwords;
libespeak-ng is always preferred when importable (frontend/g2p.py).
"""

import re
import unicodedata
from typing import List

_CLAUSE_PUNCT = ".,;:!?"
_WORD_RE = re.compile(
    r"[a-zãõáéíóúâêôàçüA-ZÃÕÁÉÍÓÚÂÊÔÀÇÜ]+"
)

IPA_VOWELS = {"a", "e", "i", "o", "u", "ɐ", "ɛ", "ɔ", "ɨ"}
_NASAL = "̃"  # combining tilde

# accented vowels: (base IPA, carries stress)
_ACCENTED = {
    "á": "a", "é": "ɛ", "í": "i", "ó": "ɔ", "ú": "u",
    "â": "ɐ", "ê": "e", "ô": "o", "à": "a",
}


def _normalize_word(w: str) -> str:
    w = w.lower()
    return "".join(
        c for c in unicodedata.normalize("NFC", w)
        if c.isalpha() or c in "ãõáéíóúâêôàçü"
    )


class PortugueseG2P:
    """EspeakG2P-interface Portuguese G2P: phonemize(text) ->
    per-clause codepoint lists with the clause punctuation appended."""

    def __init__(self, voice: str = "pt"):
        if not voice.startswith("pt"):
            raise ValueError(f"PortugueseG2P handles pt voices, got {voice}")
        self.voice = voice
        self.brazil = voice in ("pt-br", "pt-BR")

    # --- single word -> IPA segments ------------------------------------

    def word_segments(self, word: str) -> List[str]:
        w = _normalize_word(word)
        if not w:
            return []
        segs: List[str] = []
        stressed_letter = None
        i = 0
        n = len(w)

        def prev_is_vowel():
            return bool(segs) and segs[-1].rstrip(_NASAL) in IPA_VOWELS

        def coda_nasal(idx):
            """m/n at w[idx] closes the syllable (end of word or a
            consonant follows) -> nasalize the preceding vowel."""
            if idx >= n:
                return False
            if idx + 1 >= n:
                return w[idx] == "m" or w[idx] == "n"
            nxt = w[idx + 1]
            return not (nxt in "aeiouáéíóúâêôàãõ" or nxt == "h")

        while i < n:
            c = w[i]
            nxt = w[i + 1] if i + 1 < n else ""
            nxt2 = w[i + 2] if i + 2 < n else ""
            if c == "ã":
                segs.append("ɐ" + _NASAL)
                if nxt in ("o", "e"):
                    segs.append("w" if nxt == "o" else "j")
                    i += 1
                i += 1
            elif c == "õ":
                segs.append("o" + _NASAL)
                if nxt == "e":
                    segs.append("j")
                    i += 1
                i += 1
            elif c in _ACCENTED:
                base = _ACCENTED[c]
                if nxt and nxt in "mn" and coda_nasal(i + 1):
                    # também/cânhamo: accented vowel + coda nasal
                    base = {"a": "ɐ", "ɐ": "ɐ", "e": "e", "ɛ": "e",
                            "i": "i", "o": "o", "ɔ": "o",
                            "u": "u"}[base] + _NASAL
                    i += 1
                segs.append(base)
                stressed_letter = len(segs) - 1
                i += 1
            elif c in "aeiou":
                if nxt and nxt in "mn" and coda_nasal(i + 1):
                    segs.append({"a": "ɐ", "e": "e", "i": "i",
                                 "o": "o", "u": "u"}[c] + _NASAL)
                    i += 2
                else:
                    segs.append(c)
                    i += 1
            elif c == "ü":
                segs.append("w")
                i += 1
            elif c == "c":
                if nxt == "h":
                    segs.append("ʃ")
                    i += 1
                elif nxt in "eiéêí":
                    segs.append("s")
                else:
                    segs.append("k")
                i += 1
            elif c == "ç":
                segs.append("s")
                i += 1
            elif c == "g":
                if nxt in "eiéêí":
                    segs.append("ʒ")
                elif nxt == "u" and nxt2 and nxt2 in "eiéêí":
                    segs.append("ɡ")
                    i += 1  # silent u
                else:
                    segs.append("ɡ")
                i += 1
            elif c == "q":
                segs.append("k")
                if nxt == "u":
                    if nxt2 and nxt2 in "aoáóâô":
                        segs.append("w")  # quando -> kw
                    i += 1  # silent u before e/i
                i += 1
            elif c == "h":
                i += 1  # silent
            elif c == "j":
                segs.append("ʒ")
                i += 1
            elif c == "l":
                if nxt == "h":
                    segs.append("ʎ")
                    i += 2
                elif self.brazil and (i + 1 == n or nxt not in
                                      "aeiouáéíóúâêôàãõ"):
                    segs.append("w")  # BR coda-l vocalization
                    i += 1
                else:
                    segs.append("l")
                    i += 1
            elif c == "n":
                if nxt == "h":
                    segs.append("ɲ")
                    i += 2
                else:
                    segs.append("n")
                    i += 1
            elif c == "m":
                segs.append("m")
                i += 1
            elif c == "r":
                if nxt == "r":
                    segs.append("ʁ")
                    i += 2
                elif not segs or segs[-1] in ("n", "l", "s", "ʃ", "z"):
                    segs.append("ʁ")
                    i += 1
                else:
                    segs.append("ɾ")
                    i += 1
            elif c == "s":
                if nxt == "s":
                    segs.append("s")
                    i += 2
                elif prev_is_vowel() and (nxt and nxt in "aeiouáéíóúâêôàãõ"):
                    segs.append("z")
                    i += 1
                elif (i + 1 == n or nxt not in "aeiouáéíóúâêôàãõ") \
                        and not self.brazil:
                    segs.append("ʃ")  # EP coda s
                    i += 1
                else:
                    segs.append("s")
                    i += 1
            elif c == "t":
                segs.append("t")
                i += 1
            elif c == "d":
                segs.append("d")
                i += 1
            elif c == "x":
                segs.append("ʃ")
                i += 1
            elif c == "z":
                if i + 1 == n:
                    segs.append("s" if self.brazil else "ʃ")
                else:
                    segs.append("z")
                i += 1
            elif c == "y":
                segs.append("i")
                i += 1
            elif c == "w":
                segs.append("w")
                i += 1
            elif c == "k":
                segs.append("k")
                i += 1
            elif c in "bfpv":
                segs.append(c)
                i += 1
            else:
                i += 1

        # --- glides: falling diphthongs (pai -> paj, meu -> mew,
        # muito -> mujtu; an accented weak vowel stays a nucleus) -------
        for k in range(1, len(segs)):
            if segs[k] in ("i", "u") and k != stressed_letter \
                    and segs[k - 1].rstrip(_NASAL) in IPA_VOWELS \
                    and segs[k - 1].rstrip(_NASAL) != segs[k]:
                segs[k] = "j" if segs[k] == "i" else "w"

        # --- stress assignment ------------------------------------------
        nuclei = [
            k for k, s_ in enumerate(segs)
            if s_.rstrip(_NASAL) in IPA_VOWELS
        ]
        if not nuclei:
            return segs
        if stressed_letter is not None:
            target = min(nuclei, key=lambda k: abs(k - stressed_letter))
        elif len(nuclei) == 1:
            target = nuclei[0]
        elif w.endswith(("ão", "ãos", "ã", "ãs", "ães", "ões", "õe")):
            target = nuclei[-1]  # nasal-final words stress the last
        elif (w[-1] in "aeo"
              or (w[-1] == "s" and len(w) > 1 and w[-2] in "aeo")
              or w.endswith("am") or w.endswith("em")
              or w.endswith("ens")):
            target = nuclei[-2]
        else:
            target = nuclei[-1]

        # --- unstressed-vowel reduction ---------------------------------
        # final unstressed: o->u (both), e->ɨ (EP) / i (BR), a->ɐ (both)
        last = nuclei[-1]
        if last != target and last == len(segs) - 1:
            if segs[last] == "o":
                segs[last] = "u"
            elif segs[last] == "e":
                segs[last] = "ɨ" if not self.brazil else "i"
            elif segs[last] == "a":
                segs[last] = "ɐ"
        if not self.brazil:
            # EP: pretonic reduction everywhere
            for k in nuclei:
                if k == target:
                    continue
                if segs[k] == "o":
                    segs[k] = "u"
                elif segs[k] == "a":
                    segs[k] = "ɐ"
        if self.brazil:
            # BR palatalization: t/d before an i-quality vowel
            for k, s_ in enumerate(segs):
                nxt = segs[k + 1] if k + 1 < len(segs) else ""
                if nxt.rstrip(_NASAL) in ("i", "j") or nxt == "i" + _NASAL:
                    if s_ == "t":
                        segs[k] = "tʃ"
                    elif s_ == "d":
                        segs[k] = "dʒ"

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
