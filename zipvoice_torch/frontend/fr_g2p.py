"""First-party French grapheme-to-phoneme (espeak-ng fr conventions;
the port's copy of ``zipvoice_tpu/frontend/fr_g2p.py``).

Same role as frontend/es_g2p.py for the ``fr`` voice.  French needs more
than rules (silent finals, schwa, liaison), so the engine is a small
function-word lexicon (the irregular words that dominate running text)
plus an ordered rule set:

- nasal vowels: an/am/en/em -> ɑ̃, on/om -> ɔ̃, in/im/ain/ein/yn/ym -> ɛ̃,
  un/um -> œ̃ (only before a consonant or word end — "ami" keeps a+m).
- vowel digraphs: ou -> u, oi -> wa, au/eau -> o, ai/ei -> ɛ, eu/œu -> ø,
  u -> y, é -> e, è/ê -> ɛ, final -er/-ez -> e.
- consonants: ch -> ʃ, gn -> ɲ, j/g+ei -> ʒ, c+ei -> s, ç -> s, qu -> k,
  h silent, ill -> ij (fille), final consonants silent except c,r,f,l
  (the "careful" rule), s between vowels -> z.
- liaison is NOT modeled (words are phonemized in isolation, like the
  per-word espeak path the tokenizer uses).

NOT espeak; differs on words needing its full dictionary.  libespeak-ng
is preferred when importable (frontend/g2p.py).
"""

import re
import unicodedata
from typing import List

_CLAUSE_PUNCT = ".,;:!?"
_WORD_RE = re.compile(r"[a-zàâäéèêëîïôöùûüÿçœA-ZÀÂÄÉÈÊËÎÏÔÖÙÛÜŸÇŒ]+(?:'[a-z]+)?")

IPA_VOWELS = {"a", "ɑ", "e", "ɛ", "ə", "i", "o", "ɔ", "u", "y", "ø",
              "œ", "ɑ̃", "ɔ̃", "ɛ̃", "œ̃", "wa", "wɛ̃", "ɥi"}

# the irregular core of running French text
_LEXICON = {
    "le": "lə", "la": "la", "les": "le", "un": "œ̃", "une": "yn",
    "des": "de", "du": "dy", "de": "də", "et": "e", "est": "ɛ",
    "sont": "sɔ̃", "a": "a", "à": "a", "au": "o", "aux": "o",
    "ce": "sə", "ces": "se", "cette": "sɛt", "il": "il", "ils": "il",
    "elle": "ɛl", "elles": "ɛl", "je": "ʒə", "tu": "ty", "nous": "nu",
    "vous": "vu", "on": "ɔ̃", "ne": "nə", "pas": "pa", "plus": "ply",
    "que": "kə", "qui": "ki", "quoi": "kwa", "dans": "dɑ̃", "pour": "puʁ",
    "par": "paʁ", "sur": "syʁ", "avec": "avˈɛk", "sans": "sɑ̃",
    "mais": "mɛ", "ou": "u", "où": "u", "si": "si", "se": "sə",
    "sa": "sa", "son": "sɔ̃", "ses": "se", "mon": "mɔ̃", "ma": "ma",
    "mes": "me", "ton": "tɔ̃", "ta": "ta", "tes": "te", "leur": "lœʁ",
    "leurs": "lœʁ", "être": "ˈɛtʁə", "avoir": "avwˈaʁ", "fait": "fɛ",
    "faire": "fˈɛʁ", "dit": "di", "très": "tʁɛ", "bien": "bjɛ̃",
    "tout": "tu", "tous": "tus", "toute": "tut", "deux": "dø",
    "trois": "tʁwa", "temps": "tɑ̃", "ans": "ɑ̃", "hier": "jˈɛʁ",
    "monsieur": "məsjˈø", "madame": "madˈam", "oui": "wi", "non": "nɔ̃",
    "eau": "o", "yeux": "jø", "femme": "fam", "fils": "fis",
    "est-ce": "ɛs", "c'est": "sɛ", "j'ai": "ʒe", "d'un": "dœ̃",
    "hiver": "ivˈɛʁ", "sept": "sɛt", "huit": "ɥit", "dix": "dis",
    "six": "sis", "cinq": "sɛ̃k", "neuf": "nœf", "cher": "ʃɛʁ",
}

_VOW = "aàâäeéèêëiîïoôöuùûüyœ"


def _normalize_word(w: str) -> str:
    w = w.lower()
    return "".join(
        c for c in unicodedata.normalize("NFC", w)
        if c.isalpha() or c in "àâäéèêëîïôöùûüÿçœ'"
    )


def _is_nasal_context(w: str, j: int) -> bool:
    """n/m at w[j] closes a nasal vowel iff followed by a consonant or
    word end (but a doubled n/m or a following vowel denasalizes)."""
    n = len(w)
    if j + 1 >= n:
        return True
    c = w[j + 1]
    if c in _VOW or c in "nmh":
        return False
    return True


class FrenchG2P:
    """EspeakG2P-interface French G2P."""

    def __init__(self, voice: str = "fr"):
        if not voice.startswith("fr"):
            raise ValueError(f"FrenchG2P handles fr voices, got {voice}")
        self.voice = voice

    def word_segments(self, word: str) -> List[str]:
        w = _normalize_word(word)
        if not w:
            return []
        if w in _LEXICON:
            return list(_segment_ipa(_LEXICON[w]))
        # elision: l'ami, d'accord -> phonemize the clitic + the rest
        if "'" in w:
            head, _, rest = w.partition("'")
            head_ipa = {"l": "l", "d": "d", "j": "ʒ", "n": "n", "m": "m",
                        "s": "s", "c": "s", "qu": "k", "t": "t"}.get(head)
            if head_ipa and rest:
                return [head_ipa] + self.word_segments(rest)
            w = w.replace("'", "")

        segs: List[str] = []
        i = 0
        n = len(w)

        # strip one silent final consonant (not c,r,f,l,q) incl. verb -ent
        # kept simple: final s/t/d/x/z/p/g silent after a vowel or consonant
        end = n
        if (n >= 2 and w[-1] in "stdxzpg"
                and not w.endswith(("es", "ez"))):
            end = n - 1
        elif w.endswith("nc"):
            end = n - 1  # blanc, franc: final c silent after nasal
        if w.endswith("es") and n >= 3:
            end = n - 2  # final -es: silent (petites -> petit)

        while i < end:
            c = w[i]
            nxt = w[i + 1] if i + 1 < end else ""
            nxt2 = w[i + 2] if i + 2 < end else ""
            three = w[i:i + 3]
            two = w[i:i + 2]
            # --- trigraphs / digraph vowels
            if w[i:i + 4] == "eaux" or three == "eau":
                segs.append("o")
                i += 4 if w[i:i + 4] == "eaux" else 3
            elif three == "ill" and i > 0 and w[i - 1] not in _VOW:
                segs.extend(("i", "j"))  # fille -> fij
                i += 3
            elif three in ("ain", "ein") and _is_nasal_context(w, i + 2):
                segs.append("ɛ̃")
                i += 3
            elif three == "oin" and _is_nasal_context(w, i + 2):
                segs.append("wɛ̃")
                i += 3
            elif two in ("an", "am", "en", "em") and _is_nasal_context(w, i + 1):
                segs.append("ɑ̃")
                i += 2
            elif two in ("on", "om") and _is_nasal_context(w, i + 1):
                segs.append("ɔ̃")
                i += 2
            elif two in ("in", "im", "yn", "ym") and _is_nasal_context(w, i + 1):
                segs.append("ɛ̃")
                i += 2
            elif two in ("un", "um") and _is_nasal_context(w, i + 1):
                segs.append("œ̃")
                i += 2
            elif two == "ou" or two == "où":
                segs.append("u")
                i += 2
            elif two in ("oi", "oî"):
                segs.append("wa")
                i += 2
            elif two == "au":
                segs.append("o")
                i += 2
            elif two in ("ai", "ei", "aî"):
                segs.append("ɛ")
                i += 2
            elif two in ("eu", "œu") or c == "œ":
                segs.append("ø")
                i += 2 if two in ("eu", "œu") else 1
            elif two == "er" and i + 2 == end and end == n and n >= 5:
                # -er infinitive/noun reads e; short words keep ɛʁ
                # (mer, cher, fier — espeak's dictionary forms)
                segs.append("e")
                i += 2
            elif two == "ez" and i + 2 == end:
                segs.append("e")
                i += 2
            elif two == "ch":
                segs.append("ʃ")
                i += 2
            elif two == "gn":
                segs.append("ɲ")
                i += 2
            elif two == "qu":
                segs.append("k")
                i += 2
            elif two == "ph":
                segs.append("f")
                i += 2
            elif two == "th":
                segs.append("t")
                i += 2
            # --- single letters
            elif c in "aàâä":
                segs.append("a")
                i += 1
            elif c == "é":
                segs.append("e")
                i += 1
            elif c in "èêë":
                segs.append("ɛ")
                i += 1
            elif c == "e":
                if i + 1 == end and end == n:
                    pass  # final silent e
                elif i + 2 == end and nxt and nxt not in _VOW:
                    segs.append("ɛ")  # e + single final consonant (mer)
                elif (nxt and nxt2 and nxt not in _VOW
                        and nxt2 not in _VOW and nxt == nxt2):
                    segs.append("ɛ")  # e before doubled consonant (belle)
                elif (nxt and nxt2 and nxt not in _VOW and nxt2 not in _VOW):
                    segs.append("ɛ")  # closed syllable (mer... espeak ɛ)
                else:
                    segs.append("ə")
                i += 1
            elif c in "iîï":
                if nxt and nxt in _VOW and nxt not in "iî":
                    segs.append("j")  # pied -> pje
                else:
                    segs.append("i")
                i += 1
            elif c in "oôö":
                segs.append("o")
                i += 1
            elif c in "uùûü":
                if nxt == "i":
                    segs.append("ɥi")  # nuit -> nɥi
                    i += 1
                else:
                    segs.append("y")
                i += 1
            elif c == "y":
                segs.append("i")
                i += 1
            elif c == "c":
                if nxt and nxt in "eiéèêëîïy":
                    segs.append("s")
                else:
                    segs.append("k")
                i += 1
            elif c == "ç":
                segs.append("s")
                i += 1
            elif c == "g":
                if nxt and nxt in "eiéèêëîïy":
                    segs.append("ʒ")
                elif nxt == "u" and nxt2 and nxt2 in "eiéèêëîïy":
                    segs.append("ɡ")
                    i += 1
                else:
                    segs.append("ɡ")
                i += 1
            elif c == "j":
                segs.append("ʒ")
                i += 1
            elif c == "h":
                i += 1
                continue
            elif c == "s":
                if (i > 0 and w[i - 1] in _VOW and nxt and nxt in _VOW):
                    segs.append("z")
                elif nxt == "s":
                    segs.append("s")
                    i += 1
                else:
                    segs.append("s")
                i += 1
                continue
            elif c == "r":
                segs.append("ʁ")
                i += 1
            elif c == "x":
                segs.extend(("k", "s"))
                i += 1
            elif c == "w":
                segs.append("w")
                i += 1
            elif c in "bdfklmnptvz":
                if nxt == c:
                    i += 1  # doubled consonant: one sound
                segs.append(c)
                i += 1
            else:
                i += 1

        # stress: French stresses the final full syllable; espeak fr often
        # leaves it unmarked on monosyllables — mark the last non-schwa
        # nucleus like espeak's multi-syllable output
        nuclei = [k for k, s_ in enumerate(segs)
                  if s_ in IPA_VOWELS and s_ != "ə"]
        if not nuclei:
            nuclei = [k for k, s_ in enumerate(segs) if s_ in IPA_VOWELS]
        if nuclei and len([k for k, s_ in enumerate(segs)
                           if s_ in IPA_VOWELS]) >= 2:
            k = nuclei[-1]
            segs[k] = "ˈ" + segs[k]
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


def _segment_ipa(ipa: str) -> List[str]:
    """Split a lexicon IPA string into segments (combining tildes stay
    with their vowel)."""
    out = []
    for ch in ipa:
        if out and unicodedata.combining(ch):
            out[-1] += ch
        else:
            out.append(ch)
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
