"""First-party English grapheme-to-phoneme (espeak-ng en-us conventions;
the port's copy of ``zipvoice_tpu/frontend/en_g2p.py`` and its lexicon).

The reference phonemizes English with piper-phonemize, a C++ wrapper around
espeak-ng (reference zipvoice/tokenizer/tokenizer.py:32-39,160).  That
library is unavailable offline, so this module provides a self-contained
G2P with the same output *shape* and the same phoneme inventory:

- IPA strings in espeak-ng's en-us conventions: ``ɡ`` is U+0261, the
  rhotic is ``ɹ``, r-colored schwa ``ɚ``, long marks ``ː``, reduced
  ``ᵻ`` (espeak's -es/-ed vowel), flapped ``ɾ`` for intervocalic t.
- Stress marks ``ˈ``/``ˌ`` placed immediately before the stressed
  *vowel* (espeak placement, e.g. "hello" -> ``həlˈoʊ``).
- Output is a list of per-clause phoneme lists where every phoneme is a
  single codepoint (the downstream token files map codepoints to ids,
  mirroring piper's ``get_espeak_map`` inventory — see
  bin/make_model_dir.py).

Architecture: a hand-written lexicon (data/en_lexicon.txt, ~1.7k of the
most frequent words), morphological decomposition (plural/possessive
-s/-es, -ed, -ing, -er/-est, -ly and friends with voicing assimilation and
e-restoration), acronym letter spell-out, and an ordered context-sensitive
letter-to-sound rule set with a stress heuristic for everything else.

This is NOT espeak and will differ from it on hard words; its purpose is
(a) a real phoneme (not character) token stream through the exact
reference pipeline, (b) a fully deterministic, pinnable contract for the
tokenizer fixtures, and (c) sane pronunciations for demos and serving.
When libespeak-ng is importable it is always preferred (frontend/g2p.py).
"""

import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

_DATA = os.path.join(os.path.dirname(__file__), "data", "en_lexicon.txt")

# Vowel nuclei (segment strings the LTS engine emits).  Used for stress
# placement and flapping.  Multi-codepoint entries are split only at the
# very end, so segments stay phonologically meaningful internally.
VOWELS = {
    "iː", "ɪ", "eɪ", "ɛ", "æ", "ɑː", "ʌ", "ɔː", "oʊ", "oː", "ʊ", "uː",
    "aɪ", "aʊ", "ɔɪ", "ɚ", "ɜː", "ə", "ɐ", "i", "ᵻ", "u",
}

LETTER_NAMES = {
    "a": "ˈeɪ", "b": "bˈiː", "c": "sˈiː", "d": "dˈiː", "e": "ˈiː",
    "f": "ˈɛf", "g": "dʒˈiː", "h": "ˈeɪtʃ", "i": "ˈaɪ", "j": "dʒˈeɪ",
    "k": "kˈeɪ", "l": "ˈɛl", "m": "ˈɛm", "n": "ˈɛn", "o": "ˈoʊ",
    "p": "pˈiː", "q": "kjˈuː", "r": "ˈɑːɹ", "s": "ˈɛs", "t": "tˈiː",
    "u": "jˈuː", "v": "vˈiː", "w": "dˈʌbəljˌuː", "x": "ˈɛks",
    "y": "wˈaɪ", "z": "zˈiː",
}

# final-sound classes for -s / -ed assimilation.  Includes the
# voiceless sibilants s/ʃ (and tʃ via its ʃ tail): -s after those is
# routed to ᵻz by _SIBILANT_TAILS first, but -ed must DEVOICE
# (missed -> mˈɪst, wished -> wˈɪʃt, watched -> wˈɑːtʃt), matching
# espeak (ADVICE r4)
_VOICELESS = set("ptkfθsʃ")
_SIBILANT_TAILS = ("s", "z", "ʃ", "ʒ", "tʃ", "dʒ")

_V = "aeiouy"
_C = "bcdfghjklmnpqrstvwxz"


@lru_cache(maxsize=1)
def _lexicon() -> Dict[str, str]:
    table: Dict[str, str] = {}
    with open(_DATA, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            word, ipa = line.split(" ", 1)
            table.setdefault(word, ipa.strip())
    extra = os.environ.get("ZIPVOICE_EN_LEXICON")
    if extra and os.path.exists(extra):
        with open(extra, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                word, ipa = line.split(None, 1)
                table[word.lower()] = ipa.strip()
    return table


# ---------------------------------------------------------------------------
# Letter-to-sound rules.  Each rule: (grapheme, left, right, phones)
# where left/right are regexes over the *spelling* context (left matched
# against the consumed prefix with $ anchoring, right against the
# remainder).  First match wins; within a position longer graphemes are
# tried first because the list is ordered that way.
# phones is a tuple of segment strings ("" = silent).
# ---------------------------------------------------------------------------

_R = [
    # --- silent/boundary clusters -----------------------------------------
    ("ought", "", "", ("ɔː", "t")),
    ("aught", "", "", ("ɔː", "t")),
    ("eigh", "", "", ("eɪ",)),
    ("augh", "", "$", ("æ", "f")),  # laugh
    ("augh", "", "", ("ɔː",)),
    ("ough", "c", "$", ("ɔː", "f")),  # cough
    ("ough", "([rt]|en)", "$", ("ʌ", "f")),  # rough, tough, enough
    ("ough", "", "$", ("oʊ",)),  # though, dough
    ("ough", "", "", ("ʌ", "f")),
    ("igh", "", "", ("aɪ",)),
    # --- consonant digraphs ------------------------------------------------
    ("thm", "", "$", ("θ", "ə", "m")),
    ("rh", "^", "", ("ɹ",)),
    ("ps", "^", "", ("s",)),  # psychology
    ("gue", "", "$", ("ɡ",)),  # tongue, dialogue
    ("que", "", "$", ("k",)),  # unique, technique
    ("tch", "", "", ("tʃ",)),
    ("dge", "", "", ("dʒ",)),
    ("ck", "", "", ("k",)),
    ("ch", "", f"[{_C}]", ("k",)),  # techn-, chrome, christ
    ("ch", "", "", ("tʃ",)),
    ("sh", "", "", ("ʃ",)),
    # th is voiced between vowel letters and in -ther (mother, either)
    ("th", f"[{_V}]", f"[{_V}]", ("ð",)),
    ("th", "", "er", ("ð",)),
    ("th", "", "", ("θ",)),
    ("ph", "", "", ("f",)),
    ("gh", "^", "", ("ɡ",)),
    ("gh", "", "", ("",)),  # silent elsewhere (light, weigh)
    ("wh", "", "o", ("h",)),  # who, whole
    ("wh", "", "", ("w",)),
    ("wor", "^", f"[{_C}]", ("w", "ɜː")),  # work, word, world
    ("wr", "^", "", ("ɹ",)),
    ("kn", "^", "", ("n",)),
    ("gn", "^", "", ("n",)),
    ("gn", "", "$", ("n",)),
    ("mb", "", "$", ("m",)),
    ("qu", "", "", ("k", "w")),
    ("ongue", "", "$", ("ʌ", "ŋ")),  # tongue
    ("ngue", "", "$", ("ŋ",)),
    ("ng", "", "$", ("ŋ",)),
    ("ng", "", f"[{_C}]", ("ŋ",)),
    ("ng", "", "[ei]", ("n", "dʒ")),
    ("ng", "", "", ("ŋ", "ɡ")),
    ("nk", "", "", ("ŋ", "k")),
    ("le", f"[{_C}]", "$", ("ə", "l")),  # syllabic -le (table, beetle)
    ("les", f"[{_C}]", "$", ("ə", "l", "z")),  # tables, beetles
    # --- inflectional endings (silent e + voicing assimilation) ------------
    # -es/-ed after a consonant letter: the e is silent and the s/d
    # assimilates in voicing (makes/jones; liked/loved).  After sibilant
    # graphemes the vowel survives as espeak's reduced ᵻ (boxes, roses).
    # the -es/-ed endings are INFLECTIONS: the stem must already have a
    # vowel, else "fed"/"bed"/"wares" would lose their own nucleus to the
    # suffix reading (round-5 stream-harness fix)
    ("es", f"[{_V}][a-z]*(sh|ch|dg|[scxzg])", "$", ("ᵻ", "z")),
    ("es", f"[{_V}][a-z]*[ptkf]", "$", ("s",)),
    ("es", f"[{_V}][a-z]*[{_C}]", "$", ("z",)),
    ("ed", f"[{_V}][a-z]*(t|d)", "$", ("ᵻ", "d")),
    ("ed", f"[{_V}][a-z]*([pkf]|sh|ch|ss|[cx])", "$", ("t",)),
    ("ed", f"[{_V}][a-z]*[{_C}]", "$", ("d",)),
    ("sc", "", "[eiy]", ("s",)),
    ("cc", "", "[eiy]", ("k", "s")),
    ("cc", "", "", ("k",)),
    # --- single consonants (with doubling collapse) -------------------------
    ("bb", "", "", ("b",)),
    ("dd", "", "", ("d",)),
    ("ff", "", "", ("f",)),
    ("gg", "", "", ("ɡ",)),
    ("ll", "", "", ("l",)),
    ("mm", "", "", ("m",)),
    ("nn", "", "", ("n",)),
    ("pp", "", "", ("p",)),
    ("rr", "", "", ("ɹ",)),
    ("ss", "", "ure", ("ʃ",)),  # pressure
    ("ss", "", "ion", ("ʃ",)),  # mission
    ("ss", "", "", ("s",)),
    ("tt", "", "", ("t",)),
    ("zz", "", "", ("z",)),
    ("b", "", "", ("b",)),
    ("c", "", "[eiy]", ("s",)),
    ("c", "", "", ("k",)),
    ("d", "", "", ("d",)),
    ("f", "", "", ("f",)),
    ("g", "", "[eiy]", ("dʒ",)),
    ("g", "", "", ("ɡ",)),
    ("h", "", "", ("h",)),
    ("j", "", "", ("dʒ",)),
    ("k", "", "", ("k",)),
    ("l", "", "", ("l",)),
    ("m", "", "", ("m",)),
    ("n", "", "", ("n",)),
    ("p", "", "", ("p",)),
    ("r", "", "", ("ɹ",)),
    ("s", f"[{_V}]", f"[{_V}]", ("z",)),  # intervocalic s -> z (rose)
    ("s", "(oe|[aeiou][yw])", "$", ("z",)),  # plural after glide: days, shoes
    # final -s voices after a voiced consonant (bells, bars, gulls, lens);
    # vowel-final words keep /s/ (bus, gas, atlas, famous)
    ("s", f"[{_V}][a-z]*[lmnrbdgvw]", "$", ("z",)),
    ("s", "", "", ("s",)),
    ("t", "", "ion", ("ʃ",)),  # -tion caught here too when suffix missed
    ("t", "", "ure", ("tʃ",)),  # nature
    ("t", "", "", ("t",)),
    ("v", "", "", ("v",)),
    ("w", "", "", ("w",)),
    ("x", "^", "", ("z",)),
    ("xc", "", "[eiy]", ("k", "s")),  # excite
    ("x", "e", f"[{_V}]", ("ɡ", "z")),  # exact, example
    ("x", "", "", ("k", "s")),
    ("z", "", "", ("z",)),
    # --- vowel digraphs ------------------------------------------------------
    # unstressed initial a- (about, again, away): word-initial a before a
    # single consonant + vowel reads as the reduced ɐ
    ("a", "^", f"[{_C}](?!e[sd]?$)[{_V}]", ("ɐ",)),  # not magic-e (age, ate)
    ("ould", "", "$", ("ʊ", "d")),  # would, could, should
    ("iew", "", "", ("j", "uː")),  # view, review
    ("air", "", "", ("ɛ", "ɹ")),
    ("are", "", "$", ("ɛ", "ɹ")),
    ("ear", "", f"[{_C}]", ("ɜː",)),  # learn, earth
    ("ear", "", "", ("ɪ", "ɹ")),  # hear, near
    ("eer", "", "", ("ɪ", "ɹ")),
    ("ere", "", "$", ("ɪ", "ɹ")),
    ("oor", "", "", ("ɔː", "ɹ")),
    ("our", "", "$", ("aʊ", "ɚ")),
    ("our", "", "", ("ɔː", "ɹ")),
    ("ure", "([pckmb])", "s?$", ("j", "ʊ", "ɹ")),  # pure, cure, secure
    ("ure", "", "$", ("ɚ",)),  # (failure-type; 'ture' handled above)
    ("ier", f"[{_V}].*[{_C}]", "s?$", ("i", "ɚ")),  # barrier, carrier
    ("ior", f"[{_V}].*[{_C}]", "s?$", ("i", "ɚ")),  # senior, behavior
    ("alm", "", "$", ("ɑː", "m")),  # calm, palm
    ("olk", "", "$", ("oʊ", "k")),  # folk, yolk
    ("ange", f"^[{_C}]*", "$", ("eɪ", "n", "dʒ")),  # change, strange
    ("arr", "", f"[{_V}]", ("æ", "ɹ")),  # carry, arrow (not ɑːɹ+ɹ)
    ("ai", "", "", ("eɪ",)),
    ("ay", "", "", ("eɪ",)),
    ("au", "", "", ("ɔː",)),
    ("aw", "", "", ("ɔː",)),
    ("alk", "", "", ("ɔː", "k")),
    ("all", "", "", ("ɔː", "l")),
    # unstressed final -ar/-or in multisyllables reduce to ɚ (sugar,
    # color); an earlier vowel in the prefix marks multisyllabicity
    ("ar", f"[{_V}].*[{_C}]", "s?$", ("ɚ",)),
    ("ar", "", "", ("ɑː", "ɹ")),
    ("ee", "", "", ("iː",)),
    ("ea", "", "", ("iː",)),
    ("ei", "", "", ("eɪ",)),
    ("ey", "", "$", ("i",)),
    ("ey", "", "", ("eɪ",)),
    ("ew", "", "", ("uː",)),
    ("eu", "", "", ("uː",)),
    ("er", "", "$", ("ɚ",)),
    ("er", "", "", ("ɜː",)),
    # -ies/-ied: tries/flies -> aɪ in monosyllabic stems, cities/armies -> i
    # in longer ones (an earlier vowel in the prefix marks multisyllabicity)
    ("ies", f"[{_V}].*[{_C}]", "$", ("i", "z")),
    ("ies", "", "$", ("aɪ", "z")),
    ("ied", f"[{_V}].*[{_C}]", "$", ("i", "d")),
    ("ied", "", "$", ("aɪ", "d")),
    ("ie", "", "$", ("aɪ",)),
    ("ie", "", "", ("iː",)),
    ("oe", "", "s?$", ("oʊ",)),
    ("ire", "", "s?$", ("aɪ", "ɚ")),  # fire, desire
    ("ion", "", "$", ("i", "ə", "n")),  # opinion (tion/sion peel earlier)
    ("ir", "", "", ("ɜː",)),
    ("oa", "", "", ("oʊ",)),
    ("oo", "", "k", ("ʊ",)),
    ("oo", "", "", ("uː",)),
    ("oi", "", "", ("ɔɪ",)),
    ("oy", "", "", ("ɔɪ",)),
    ("ou", "", "", ("aʊ",)),
    ("ow", "", "$", ("oʊ",)),
    ("ow", "", "", ("aʊ",)),
    ("ore", "", "$", ("oː", "ɹ")),
    ("or", f"[{_V}].*[{_C}]", "s?$", ("ɚ",)),  # color, error, majors
    ("or", "", "", ("ɔː", "ɹ")),
    ("old", "", "", ("oʊ", "l", "d")),
    ("ur", "", "", ("ɜː",)),
    ("ue", "", "$", ("uː",)),
    ("ui", "", "", ("uː",)),
    # --- single vowels -------------------------------------------------------
    # magic-e long vowels: V + single consonant + final e, including the
    # inflected spellings where -s/-d follows the silent e (makes, used)
    ("a", "", f"[{_C}]e[sd]?$", ("eɪ",)),
    ("u", "[bcfghkmpv]", f"[{_C}]e([sd]|r|rs)?$", ("j", "uː")),  # cube, fume
    ("u", "^", f"[{_C}]e([sd]|r|rs)?$", ("j", "uː")),  # use, user, used
    ("u", "^", f"[{_C}][{_V}]", ("j", "uː")),  # unique, union
    ("i", "", f"[{_C}]e[sd]?$", ("aɪ",)),
    ("o", "", f"[{_C}]e[sd]?$", ("oʊ",)),
    ("u", "", f"[{_C}]e([sd]|r|rs)?$", ("uː",)),
    ("e", "", f"[{_C}]e[sd]?$", ("iː",)),
    ("ind", "", "$", ("aɪ", "n", "d")),
    ("ild", "", "$", ("aɪ", "l", "d")),
    ("a", "", "$", ("ə",)),
    ("a", "", "", ("æ",)),
    ("e", f"[{_C}]", "$", ("",)),  # silent final e
    ("e", "", "$", ("iː",)),  # he-style open final (rare in OOV)
    ("e", "", "", ("ɛ",)),
    ("i", "", "$", ("i",)),
    ("i", "", "", ("ɪ",)),
    ("o", "", "$", ("oʊ",)),
    ("o", "", "", ("ɑː",)),
    ("u", "", "", ("ʌ",)),
    ("y", "^", "", ("j",)),
    ("y", "", "$", ("i",)),
    ("y", "", f"[{_V}]", ("j",)),
    ("y", "", "", ("ɪ",)),
    ("'", "", "", ("",)),
]

# suffix -> (phones appended, stress_hint); stress_hint: None = keep base,
# an int = stressed-nucleus index counted from the END of the full nucleus
# list (classic Latinate stress-attracting suffixes).
_SUFFIX_PHONES = {
    "ization": (("aɪ", "z", "eɪ", "ʃ", "ə", "n"), 2),
    "isation": (("aɪ", "z", "eɪ", "ʃ", "ə", "n"), 2),
    "ation": (("eɪ", "ʃ", "ə", "n"), 2),
    "ition": (("ɪ", "ʃ", "ə", "n"), 2),
    "tion": (("ʃ", "ə", "n"), 2),
    "ssion": (("ʃ", "ə", "n"), 2),
    "sion": (("ʒ", "ə", "n"), 2),
    "gion": (("dʒ", "ə", "n"), 2),
    "iage": (("ɪ", "dʒ"), None),
    "cially": (("ʃ", "ə", "l", "i"), 3),
    "tially": (("ʃ", "ə", "l", "i"), 3),
    "cial": (("ʃ", "ə", "l"), 2),
    "tial": (("ʃ", "ə", "l"), 2),
    "ally": (("ə", "l", "i"), None),
    "cian": (("ʃ", "ə", "n"), 2),
    "ture": (("tʃ", "ɚ"), None),
    "sure": (("ʒ", "ɚ"), None),
    "ment": (("m", "ə", "n", "t"), None),
    "ness": (("n", "ə", "s"), None),
    "ful": (("f", "ə", "l"), None),
    "less": (("l", "ə", "s"), None),
    "ious": (("i", "ə", "s"), None),
    "ous": (("ə", "s"), None),
    "ial": (("i", "ə", "l"), 2),
    "able": (("ə", "b", "ə", "l"), None),
    "ible": (("ɪ", "b", "ə", "l"), None),
    "ique": (("iː", "k"), 1),
    "ity": (("ɪ", "ɾ", "i"), 3),
    "ism": (("ɪ", "z", "ə", "m"), None),
    "ize": (("aɪ", "z"), None),
    "ise": (("aɪ", "z"), None),
    "ify": (("ɪ", "f", "aɪ"), None),
    "age": (("ɪ", "dʒ"), None),
    "ive": (("ɪ", "v"), None),
    "ic": (("ɪ", "k"), 2),
    "al": (("ə", "l"), None),
    "ly": (("l", "i"), None),
}


def _match_rule(word: str, i: int) -> Tuple[Tuple[str, ...], int]:
    """Find the first matching LTS rule at position i; returns (phones,
    chars consumed).  Left context is a regex matched against the end of
    the consumed prefix ("^" = word start); right context is matched
    against the start of the remainder ("$" inside it = word end)."""
    rest = word[i:]
    prefix = word[:i]
    for grapheme, left, right, phones in _R:
        if not rest.startswith(grapheme):
            continue
        if left and not re.search(left + r"\Z", prefix):
            continue
        tail = rest[len(grapheme):]
        if right and not re.match(right, tail):
            continue
        return phones, len(grapheme)
    return (), 1  # unknown char: skip


def _lts_segments(word: str, ensure_nucleus: bool = True) -> List[str]:
    """Run the rule engine; returns phone segments (no stress marks).

    ``ensure_nucleus=False`` is for stems whose suffix supplies the
    nucleus (na+tion): no schwa is inserted into a vowel-less stem.
    """
    segs: List[str] = []
    i = 0
    while i < len(word):
        phones, n = _match_rule(word, i)
        segs.extend(p for p in phones if p)
        i += n
    if ensure_nucleus and not any(s in VOWELS for s in segs) and word:
        # every word needs a nucleus (e.g. silent-e-only words): re-read a
        # final 'e' as ɛ, else insert ə before the last consonant
        if word.rstrip("'").endswith("e"):
            segs.append("ɛ")
        elif segs:
            segs.insert(len(segs) - 1, "ə")
    return segs


_WEAK = {"ə", "ɐ", "ɚ", "ᵻ"}


def _assign_stress(segs: List[str], nucleus_from_end: Optional[int] = None
                   ) -> List[str]:
    """Insert a primary stress mark before one nucleus (espeak placement)."""
    nuclei = [k for k, s in enumerate(segs) if s in VOWELS]
    if not nuclei:
        return segs
    if nucleus_from_end is not None and len(nuclei) >= nucleus_from_end:
        target = nuclei[-nucleus_from_end]
    else:
        target = None
        for k in nuclei[:-1] if len(nuclei) > 1 else nuclei:
            if segs[k] not in _WEAK:
                target = k
                break
        if target is None:
            target = nuclei[0]
    out = list(segs)
    out.insert(target, "ˈ")
    return out


def _flap(segs: List[str]) -> List[str]:
    """Intervocalic t -> ɾ before an unstressed vowel (espeak en-us)."""
    out = list(segs)
    for k in range(1, len(out) - 1):
        if out[k] != "t":
            continue
        prev_ok = out[k - 1] in VOWELS or (
            out[k - 1] == "ɹ" and k >= 2 and out[k - 2] in VOWELS
        )
        if prev_ok and out[k + 1] in VOWELS:
            out[k] = "ɾ"
    return out


def _s_suffix(ipa: str) -> str:
    for t in _SIBILANT_TAILS:
        if ipa.endswith(t):
            return ipa + "ᵻz"
    last = ipa[-1]
    return ipa + ("s" if last in _VOICELESS else "z")


def _ed_suffix(ipa: str) -> str:
    if ipa.endswith(("t", "d")) and not ipa.endswith(("ɾ",)):
        return ipa + "ᵻd"
    last = ipa[-1]
    return ipa + ("t" if last in _VOICELESS else "d")


def _strip_stress(ipa: str) -> str:
    return ipa.replace("ˈ", "").replace("ˌ", "")


# closed-class words never serve as inflection bases: without this,
# "wed" decomposes as we+d -> wiːd and "shed" as she+d -> ʃiːd
# (round-5 stream-harness fix)
_NO_INFLECT_BASE = {
    "a", "i", "he", "she", "we", "be", "me", "ye", "the", "to", "so",
    "no", "do", "by", "my", "of", "or", "if", "an", "at", "on", "in",
    "as", "is", "us", "it",
}


def _morph(word: str) -> Optional[str]:
    """Try morphological decomposition against the lexicon."""
    lex = _lexicon()

    def base(b: str) -> Optional[str]:
        if b in _NO_INFLECT_BASE:
            return None
        return lex.get(b)

    if word.endswith("'s") or word.endswith("s'"):
        b = base(word[:-2] if word.endswith("'s") else word[:-1])
        if b:
            return _s_suffix(b)
    if word.endswith("ies") and base(word[:-3] + "y"):
        b = base(word[:-3] + "y")
        # cities: -i + iz; flies (y said aɪ): just + z
        return b + "z" if b.endswith("ɪ") else _strip_final(b, "i") + "iz"
    if word.endswith("es"):
        for blen in (1, 2):  # makes -> make first; boxes -> box
            b = base(word[:-blen])
            if b:
                return _s_suffix(b)
    if word.endswith("s") and not word.endswith("ss"):
        b = base(word[:-1])
        if b:
            return _s_suffix(b)
    if word.endswith("ied") and base(word[:-3] + "y"):
        b = base(word[:-3] + "y")
        return b + "d" if b.endswith("ɪ") else _strip_final(b, "i") + "id"
    if word.endswith("ed"):
        # e-restoration first ("used" is use+d, not us+ed)
        for b_ in (word[:-1], word[:-2],
                   word[:-3] if _doubled(word[:-2]) else None):
            if b_ and base(b_):
                return _ed_suffix(base(b_))
    if word.endswith("ing"):
        raw = word[:-3]
        # e-restoration only on a real stem ("thing" is not the+ing); for
        # consonant-final raws prefer it ("using" is use+ing, not us+ing)
        restored = raw + "e" if any(c in _V for c in raw) else None
        cands = ([raw, restored] if (raw and raw[-1] in _V)
                 else [restored, raw])
        for b_ in cands + [word[:-4] if _doubled(raw) else None]:
            if b_ and base(b_):
                return base(b_) + "ɪŋ"
    if word.endswith("er"):
        for b_ in (word[:-1], word[:-2],
                   word[:-3] if _doubled(word[:-2]) else None,
                   word[:-3] + "y" if word.endswith("ier") else None):
            if b_ and base(b_):
                return _trim_weak_final(base(b_)) + "ɚ"
    if word.endswith("est"):
        for b_ in (word[:-3], word[:-2],
                   word[:-4] + "y" if word.endswith("iest") else None):
            if b_ and base(b_):
                return _trim_weak_final(base(b_)) + "əst"
    if word.endswith("ly") and base(word[:-2]):
        return base(word[:-2]) + "li"
    if word.endswith("ty") and base(word[:-2]):
        return base(word[:-2]) + "ti"  # safety, ninety
    if word.endswith("ness") and base(word[:-4]):
        return base(word[:-4]) + "nəs"
    if word.endswith("ment") and base(word[:-4]):
        return base(word[:-4]) + "mənt"
    if word.endswith("ful") and base(word[:-3]):
        return base(word[:-3]) + "fəl"
    if word.endswith("less") and base(word[:-4]):
        return base(word[:-4]) + "ləs"
    for pre, ph in (("un", "ʌn"), ("re", "ɹiː"), ("non", "nɑːn"),
                    ("dis", "dɪs"), ("pre", "pɹiː"), ("mis", "mɪs"),
                    ("over", "ˌoʊvɚ"), ("under", "ˌʌndɚ"), ("out", "ˌaʊt")):
        stem = word[len(pre):]
        # the stem must be a plausible word, not an abbreviation entry
        # ("rest" is not re+st): >=3 letters with a vowel letter
        if (word.startswith(pre) and len(stem) >= 3
                and any(c in _V for c in stem) and base(stem)):
            return ph + base(stem)
    # closed compounds: both halves are lexicon words (somewhere, headache);
    # espeak keeps the first element's stress and strips the second's.
    # Halves must be >=3/>=4 letters — shorter second halves produce false
    # splits (summary != sum+mary) far more often than real compounds.
    if len(word) >= 7:
        for cut in range(3, len(word) - 3):
            a, b = word[:cut], word[cut:]
            if (base(a) and base(b)
                    and any(c in _V for c in a) and any(c in _V for c in b)):
                return base(a) + _strip_stress(base(b))
    return None


def _doubled(stem: str) -> bool:
    return len(stem) >= 2 and stem[-1] == stem[-2] and stem[-1] in _C


def _strip_final(ipa: str, ch: str) -> str:
    return ipa[: -len(ch)] if ipa.endswith(ch) else ipa


def _trim_weak_final(ipa: str) -> str:
    # "big" + er keeps ɡ; "late" + er: lexicon form lˈeɪt -> flap
    if ipa.endswith("t"):
        return ipa[:-1] + "ɾ"
    return ipa


def word_to_ipa(word: str, spell_acronym: bool = False,
                _no_direct_lookup: bool = False) -> str:
    """One (already normalized) word -> espeak-style IPA string.

    ``_no_direct_lookup`` disables the word's own lexicon entry (morphology
    may still use OTHER entries) — the held-out PER harness
    (tools/g2p_per.py) uses it to measure the true OOV path.
    """
    lower = word.lower().strip("'")
    if not lower:
        return ""
    lex = _lexicon()
    if spell_acronym or not any(c in _V for c in lower):
        if lower in lex and not _no_direct_lookup:
            return lex[lower]
        return "".join(LETTER_NAMES.get(c, "") for c in lower)
    if lower in lex and not _no_direct_lookup:
        return lex[lower]
    m = _morph(lower)
    if m:
        return m
    # suffix-aware LTS: peel one known suffix, LTS the stem.  Stress-
    # attracting suffixes (hint set) accept any stem, even vowel-less
    # (na+tion, so+cial); reduced-vowel suffixes require a real stem —
    # a consonant-final stem with a vowel — else the word is a
    # monosyllable where the letters are part of the rime (cage, five).
    for suf, (phones, hint) in _SUFFIX_PHONES.items():
        if not lower.endswith(suf) or len(lower) < len(suf) + 1:
            continue
        stem = lower[: -len(suf)]
        if hint is None and not (
            len(stem) >= 2 and stem[-1] in _C and any(c in _V for c in stem)
        ):
            continue
        if stem and stem[-1] in "aeiouy" and len(stem) <= 3:
            # short vowel-final stem: open syllable before a single-onset
            # suffix reads long (so+cial, na+tion); a double-consonant
            # suffix closes the syllable and the vowel reads short
            # (mi+ssion, se+ssion)
            if len(suf) >= 2 and suf[0] == suf[1]:
                v = {"a": "æ", "e": "ɛ", "i": "ɪ", "o": "ɑː",
                     "u": "ʌ", "y": "ɪ"}[stem[-1]]
            else:
                v = {"a": "eɪ", "e": "iː", "i": "aɪ", "o": "oʊ",
                     "u": "uː", "y": "aɪ"}[stem[-1]]
            segs = _lts_segments(stem[:-1], ensure_nucleus=False) + [v]
        else:
            segs = _lts_segments(stem, ensure_nucleus=False)
        segs = segs + list(phones)
        segs = _assign_stress(segs, nucleus_from_end=hint)
        return "".join(_flap(segs))
    segs = _assign_stress(_lts_segments(lower))
    return "".join(_flap(segs))


def word_source(word: str, spell_acronym: bool = False) -> str:
    """Which path ``word_to_ipa`` takes for this word: 'lexicon' (direct
    entry — espeak-grade by construction), 'acronym' (letter spell-out),
    'morph' (inflection of a lexicon base — one deterministic rule away
    from an entry), or 'lts' (letter-to-sound rules — the path the
    held-out PER of tools/g2p_per.py measures).  Used by
    tools/g2p_stream.py to decompose the running-text token stream."""
    lower = word.lower().strip("'")
    if not lower:
        return "lts"
    lex = _lexicon()
    if spell_acronym or not any(c in _V for c in lower):
        return "lexicon" if lower in lex else "acronym"
    if lower in lex:
        return "lexicon"
    if _morph(lower):
        return "morph"
    return "lts"


_WORD_RE = re.compile(r"[A-Za-z]+(?:'[A-Za-z]+)*")
_CLAUSE_PUNCT = ".,;:!?"


class EnglishG2P:
    """First-party English G2P with the EspeakG2P interface
    (frontend/g2p.py): ``phonemize(text) -> List[List[str]]`` per-clause
    codepoint lists with the clause punctuation appended."""

    def __init__(self, voice: str = "en-us"):
        if not voice.startswith("en"):
            raise ValueError(f"EnglishG2P only handles en voices, got {voice}")
        self.voice = voice

    def phonemize(self, text: str) -> List[List[str]]:
        out: List[List[str]] = []
        for clause, punct in _split_clauses(text):
            ipa_words = []
            for m in _WORD_RE.finditer(clause):
                w = m.group(0)
                spell = w.isupper() and len(w) >= 2
                ipa = word_to_ipa(w, spell_acronym=spell)
                if ipa:
                    ipa_words.append(ipa)
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


# The espeak phoneme codepoint inventory (piper get_espeak_map tokens that
# our English output can emit + the broader IPA set so token files cover
# real-espeak output when the library IS present).
ESPEAK_IPA_CODEPOINTS = sorted(
    set("".join(sorted(VOWELS)))
    | set("pbtdkɡfvθðszʃʒhmnŋlɹjwɾʔ")
    | set("ˈˌːˑ")
    | set("æçøŋœɐɑɒɔəɚɛɜɞɟɣɤɥɦɨɪɫɬɭɮɯɰɱɲɳɴɵɶɸɺɻɽʀʁʂʄʈʉʊʋʌʍʎʏʐʑʕʘʙʛʜʝʟʡʢβχᵻⱱ")
)
