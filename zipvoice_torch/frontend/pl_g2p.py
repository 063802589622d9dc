"""First-party Polish grapheme-to-phoneme (espeak-ng pl conventions;
the port's copy of ``zipvoice_tpu/frontend/pl_g2p.py``).

The reference phonemizes every voice with piper-phonemize/espeak-ng
(reference zipvoice/tokenizer/tokenizer.py:127-198).  Offline, voices
without a first-party engine fall back to character G2P; this module
gives Polish a real phoneme stream.  Polish orthography is close to
phonemic and stress is fixed, so a rule engine covers it well:

- digraphs/trigraphs: sz->ʂ, cz->tʂ, rz/ż->ʐ, dż->dʐ, dz->dz, dź->dʑ,
  ch/h->x, dzi/ź/zi->ʑ, ś/si->ɕ, ć/ci->tɕ, ń/ni->ɲ (the i-softening
  spelling rule: si+vowel -> ɕ with silent i, si otherwise -> ɕi).
- vowels: y->ɨ, ó->u, nasal ą->ɔ+̃ , ę->ɛ+̃ (word-final ę denasalizes
  to ɛ, the standard colloquial realization espeak uses); before stops
  the nasals surface as vowel+nasal-consonant (ą->ɔm/ɔn/ɔŋ, ę->ɛm/ɛn/
  ɛŋ by place).
- w->v, ł->w, c->ts, final-obstruent devoicing (b d g v z ʐ ʑ dz... ->
  p t k f s ʂ ɕ ts...).
- stress: fixed penultimate (espeak's pl default).

Like frontend/en_g2p.py this is NOT espeak and may differ on loanwords;
libespeak-ng is always preferred when importable (frontend/g2p.py).
"""

import re
import unicodedata
from typing import List

_CLAUSE_PUNCT = ".,;:!?"
_WORD_RE = re.compile(r"[a-ząćęłńóśźżA-ZĄĆĘŁŃÓŚŹŻ]+")

IPA_VOWELS = {"a", "ɛ", "i", "ɔ", "u", "ɨ"}
_NASAL = "̃"  # combining tilde

_DEVOICE = {
    "b": "p", "d": "t", "ɡ": "k", "v": "f", "z": "s",
    "ʐ": "ʂ", "ʑ": "ɕ", "dz": "ts", "dʐ": "tʂ", "dʑ": "tɕ",
}

# letters whose following 'i' is the softening mark
_SOFTENED = {"s": "ɕ", "z": "ʑ", "c": "tɕ", "n": "ɲ"}

_PLAIN_VOWEL = {"a": "a", "e": "ɛ", "i": "i", "o": "ɔ", "u": "u",
                "y": "ɨ", "ó": "u"}


def _normalize_word(w: str) -> str:
    w = w.lower()
    return "".join(
        c for c in unicodedata.normalize("NFC", w)
        if c.isalpha() or c in "ąćęłńóśźż"
    )


class PolishG2P:
    """EspeakG2P-interface Polish G2P: phonemize(text) -> per-clause
    codepoint lists with the clause punctuation appended."""

    def __init__(self, voice: str = "pl"):
        if not voice.startswith("pl"):
            raise ValueError(f"PolishG2P handles pl voices, got {voice}")
        self.voice = voice

    # --- single word -> IPA segments ------------------------------------

    def word_segments(self, word: str) -> List[str]:
        w = _normalize_word(word)
        if not w:
            return []
        segs: List[str] = []
        i = 0
        n = len(w)

        def nasal_or_cluster(base, idx):
            """ą/ę: before a stop surface as vowel + homorganic nasal,
            word-final ę denasalizes, else nasal vowel."""
            nxt = w[idx + 1] if idx + 1 < n else ""
            if nxt and nxt in "pb":
                return [base, "m"]
            if nxt and nxt in "tdc":
                return [base, "n"]
            if nxt and nxt in "kg":
                return [base, "ŋ"]
            if not nxt and base == "ɛ":
                return ["ɛ"]  # final ę -> ɛ
            return [base + _NASAL]

        while i < n:
            c = w[i]
            nxt = w[i + 1] if i + 1 < n else ""
            nxt2 = w[i + 2] if i + 2 < n else ""
            if c == "s" and nxt == "z":
                segs.append("ʂ")
                i += 2
            elif c == "c" and nxt == "z":
                segs.append("tʂ")
                i += 2
            elif c == "r" and nxt == "z":
                segs.append("ʐ")
                i += 2
            elif c == "d" and nxt == "ż":
                segs.append("dʐ")
                i += 2
            elif c == "d" and nxt == "ź":
                segs.append("dʑ")
                i += 2
            elif c == "d" and nxt == "z" and nxt2 == "i":
                # dzi: soft dʑ; the i is silent before a vowel,
                # syllabic otherwise (dziadek -> dʑadɛk, dziki -> dʑiki)
                segs.append("dʑ")
                after = w[i + 3] if i + 3 < n else ""
                if not (after and after in "aąeęoóuy"):
                    segs.append("i")
                i += 3
            elif c == "d" and nxt == "z":
                segs.append("dz")
                i += 2
            elif c == "c" and nxt == "h":
                segs.append("x")
                i += 2
            elif c in _SOFTENED and nxt == "i":
                segs.append(_SOFTENED[c])
                if nxt2 and nxt2 in "aąeęoóuy":
                    i += 2  # silent softening i before a vowel
                else:
                    segs.append("i")  # si/ni/... syllabic i
                    i += 2
            elif c == "ś":
                segs.append("ɕ")
                i += 1
            elif c == "ź":
                segs.append("ʑ")
                i += 1
            elif c == "ć":
                segs.append("tɕ")
                i += 1
            elif c == "ń":
                segs.append("ɲ")
                i += 1
            elif c == "ż":
                segs.append("ʐ")
                i += 1
            elif c == "ł":
                segs.append("w")
                i += 1
            elif c == "w":
                segs.append("v")
                i += 1
            elif c == "c":
                segs.append("ts")
                i += 1
            elif c == "h":
                segs.append("x")
                i += 1
            elif c == "ą":
                segs.extend(nasal_or_cluster("ɔ", i))
                i += 1
            elif c == "ę":
                segs.extend(nasal_or_cluster("ɛ", i))
                i += 1
            elif c == "i" and nxt and nxt in "aąeęoóuy":
                segs.append("j")  # palatalizing i: miasto -> mjˈastɔ
                i += 1
            elif c in _PLAIN_VOWEL:
                segs.append(_PLAIN_VOWEL[c])
                i += 1
            elif c == "g":
                segs.append("ɡ")
                i += 1
            elif c == "j":
                segs.append("j")
                i += 1
            elif c in "bdfklmnprstvz":
                segs.append(c)
                i += 1
            else:
                i += 1

        # --- final + regressive devoicing -------------------------------
        if segs and segs[-1] in _DEVOICE:
            segs[-1] = _DEVOICE[segs[-1]]
        voiceless = {"p", "t", "k", "f", "s", "ʂ", "ɕ", "x",
                     "ts", "tʂ", "tɕ"}
        for k in range(len(segs) - 2, -1, -1):
            if segs[k] in _DEVOICE and segs[k + 1] in voiceless:
                segs[k] = _DEVOICE[segs[k]]  # książka -> kɕɔ̃ʂka
        # progressive devoicing: only v and ʐ(rz) devoice AFTER a
        # voiceless consonant (świat -> ɕfjat, twój -> tfuj)
        for k in range(1, len(segs)):
            if segs[k] in ("v", "ʐ") and segs[k - 1] in voiceless:
                segs[k] = _DEVOICE[segs[k]]

        # --- fixed penultimate stress -----------------------------------
        nuclei = [
            k for k, s_ in enumerate(segs)
            if s_.rstrip(_NASAL) in IPA_VOWELS
        ]
        if not nuclei:
            return segs
        target = nuclei[-2] if len(nuclei) >= 2 else nuclei[0]
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
