"""First-party Russian grapheme-to-phoneme (espeak-ng ru conventions;
the port's copy of ``zipvoice_tpu/frontend/ru_g2p.py``).

The reference phonemizes every voice with piper-phonemize/espeak-ng
(reference zipvoice/tokenizer/tokenizer.py:127-198).  Russian is the
hardest of the first-party engines because stress is lexical and drives
vowel reduction; espeak itself ships a Russian stress dictionary.  This
module mirrors that design at a smaller scale:

- **consonants** are deterministic: palatalization before е/ё/и/ю/я/ь
  (written ``ʲ``, espeak's convention; ж/ш/ц stay hard, ч/щ stay
  soft), final devoicing and regressive voicing assimilation.
- **soft vowels** е/ё/ю/я: after a consonant they palatalize it; word-
  initially / after a vowel / after ь,ъ they take a ``j`` onset.
- **stress** comes from a built-in frequency lexicon (~400 forms), the
  ``ё`` rule (always stressed), and single-vowel words; UNKNOWN
  multi-vowel words fall back to penultimate stress and are the
  documented quality limit of the offline path.
- **vowel reduction** (akanye/ikanye): unstressed о/а -> ɐ in the
  immediately-pretonic or word-initial syllable, else ə; unstressed
  е/я -> ɪ; и/ы/у stay.

Like frontend/en_g2p.py this is NOT espeak; libespeak-ng is always
preferred when importable (frontend/g2p.py).
"""

import re
import unicodedata
from typing import List, Optional

_CLAUSE_PUNCT = ".,;:!?"
_WORD_RE = re.compile(r"[а-яёА-ЯЁ]+")

_HARD = {"ж": "ʐ", "ш": "ʂ", "ц": "ts"}      # never palatalized
_SOFT_ONLY = {"ч": "tɕ", "щ": "ɕ"}           # always soft (no ʲ mark)
_CONS = {
    "б": "b", "в": "v", "г": "ɡ", "д": "d", "з": "z", "к": "k",
    "л": "l", "м": "m", "н": "n", "п": "p", "р": "r", "с": "s",
    "т": "t", "ф": "f", "х": "x",
}
_DEVOICE = {"b": "p", "v": "f", "ɡ": "k", "d": "t", "ʐ": "ʂ", "z": "s"}
_VOICE = {v: k for k, v in _DEVOICE.items()}
_VOICELESS = {"p", "f", "k", "t", "ʂ", "s", "x", "ts", "tɕ", "ɕ"}

# soft-vowel letter -> (bare vowel after consonant, j-onset form)
_SOFT_V = {"е": "e", "ё": "o", "ю": "u", "я": "a"}
_PLAIN_V = {"а": "a", "о": "o", "у": "u", "ы": "ɨ", "и": "i", "э": "ɛ"}
_VOWEL_LETTERS = set("аоуыиэеёюя")

IPA_VOWELS = {"a", "o", "u", "ɨ", "i", "ɛ", "e", "ɐ", "ə", "ɪ"}

# ---------------------------------------------------------------------------
# Stress lexicon: word -> 1-based index of the stressed VOWEL LETTER.
# High-frequency forms (pronouns, function words are mostly monosyllabic
# and need no entry).  ё carries its own stress.
# ---------------------------------------------------------------------------
_STRESS = {}
for _line in """
спасибо2 пожалуйста2 здравствуйте1 привет2 хорошо3 плохо1 очень1
сегодня2 завтра1 вчера2 сейчас2 потом2 всегда2 никогда3 иногда3
человек3 люди1 женщина1 мужчина2 ребёнок2 дети1 друзья2 работа2
время1 жизни1 жизнь1 город1 города3 страна2 страны2 дорога2 дома2
дом1 вода2 воды1 земля2 небо1 солнце1 погода2 утро1 вечер1 ночи1
ночь1 день1 неделя2 месяц1 году2 года1 язык2 языка3 слово1 слова2
книга1 книги1 письмо2 музыка1 песня1 фильм1 школа1 учитель2
студент2 вопрос2 ответ2 проблема2 решение3 внимание3 спокойной2
доброе1 доброй2 большой2 маленький1 новый1 старый1 молодой3
красивый2 интересный3 важный1 простой2 сложный1 русский1 много1
мало1 быстро1 медленно1 громко1 тихо1 рано1 поздно1 далеко3
близко1 можно1 нужно1 нельзя2 надо1 быть1 есть1 было1 была2
будет1 будут1 делать1 делает1 сделать2 говорить3 говорит3 сказать2
сказал2 скажите2 думать1 думаю1 знать1 знаю1 знает1 понимать3
понимаю3 видеть1 вижу1 видит1 смотреть2 смотрит2 слушать1 слышать1
идти2 идёт - пойти2 пошёл - прийти2 пришёл - ехать1 едет1 ездить1
жить1 живёт - живут2 работать2 работает2 учиться2 учится1 читать2
читает2 писать2 пишет1 играть2 играет2 любить2 люблю2 любит1
хотеть2 хочу2 хочет1 мочь1 могу2 может1 давать2 даёт - дать1 дал1
взять1 взял1 найти2 нашёл - искать2 ищет1 помочь2 помогите3
купить2 купил2 продать2 стоить1 стоит1 начать2 начал1 кончить1
открыть2 закрыть2 спать1 спит1 встать1 встал1 сидеть2 сидит2
стоять2 ходить2 ходит1 бежать2 лететь2 плавать1 против2 между1
через1 около2 после1 перед1 возле1 вместе2 только1 почти2 ещё -
уже2 тоже1 также1 здесь1 туда2 сюда2 оттуда2 дальше1 ближе1
лучше1 хуже1 больше1 меньше1 конечно2 наверное2 например3 почему3
потому3 зачем2 когда2 тогда2 где1 куда2 откуда2 сколько1 столько1
несколько2 каждый1 другой2 другие2 самый1 себя2 себе2 меня2 мне1
тебя2 тебе2 него2 ему2 неё - нами1 вами1 ними1 этот1 это1 эта1
эти1 тот1 такой2 какой2 который2 наша1 ваша1 моя2 твоя2 своя2
один2 одна2 оно2 они2 она2 два1 три1 четыре2 пять1 шесть1 семь1 восемь1 девять1
десять1 сто1 тысяча1 первый1 второй2 третий1 последний2 минута2
секунда2 часа2 часов2 рубль1 деньги1 магазин3 улица1 площадь1
машина2 поезд1 самолёт - автобус2 метро2 аэропорт3 вокзал2
гостиница2 квартира2 комната1 кухня1 окно2 дверь1 стол1 стул1
телефон3 компьютер2 интернет3 новости1 газета2 театр2 кино2
история2 наука2 природа2 здоровье2 больница2 врача2 доктор1
голова3 головы2 глаза2 руки1 рука2 ноги1 нога2 сердце1 лицо2
семья2 мама1 папа1 бабушка1 дедушка1 сестра2 брат1 сына1 сын1
дочь1 жена2 муж1 обед2 ужин1 завтрак1 хлеб1 молоко3 мясо1 рыба1
овощи1 фрукты1 яблоко1 чай1 кофе1 сахар1 соль1 масло1 сыр1 суп1
каша1 вино2 пиво1 весна2 лето1 осень1 зима2 зимой2 летом1 снег1
дождь1 ветер1 холодно1 жарко1 тепло2 мороз2 россия2 москва2
россии2 москве2 мира1 мире1 мир1 война2 правда1 неправда2 счастье1
радость1 грусть1 страх1 любовь2 дружба1 помощь1 сила1 голос1
красота3 свобода2 спасибо2 будущее1 прошлое1 настоящее3
""".split():
    if "ё" in _line or not _line[-1].isdigit():
        continue  # ё words stress themselves; stray separators ignored
    _STRESS[_line[:-1]] = int(_line[-1])


# words ending -ого/-его where г is really /g/ (adverbs), exempt from
# the genitive-ending -ого/-его -> -ово/-ево rule
_OGO_G = {"много", "немного", "строго", "дорого", "полого", "отлого"}
# lexicalized spelling-pronunciation rewrites
_SPECIAL = {
    "сегодня": "севодня", "его": "ево", "него": "нево",
    "чего": "чево", "ничего": "ничево", "никого": "никово",
    "кого": "ково", "того": "тово", "всего": "всево",
    "сегодняшний": "севодняшний",
}
# silent-cluster simplifications (espeak applies the same)
_CLUSTERS = [
    ("вств", "ств"), ("лнц", "нц"), ("стн", "сн"), ("здн", "зн"),
    ("рдц", "рц"), ("стл", "сл"), ("сч", "щ"), ("зч", "щ"),
]


def _rewrite(w: str) -> str:
    """Cluster simplification + degemination (shared by word
    normalization and stress-lexicon key registration, so lookups see
    the same spelling)."""
    for a, b in _CLUSTERS:
        w = w.replace(a, b)
    out = []
    for c in w:
        if out and out[-1] == c and c not in _VOWEL_LETTERS:
            continue
        out.append(c)
    return "".join(out)


def _normalize_word(w: str) -> str:
    w = w.lower()
    w = "".join(
        c for c in unicodedata.normalize("NFC", w) if c in
        set("абвгдежзийклмнопрстуфхцчшщъыьэюяё")
    )
    w = _SPECIAL.get(w, w)
    if (w.endswith("ого") or w.endswith("его")) and w not in _OGO_G \
            and len(w) > 3:
        w = w[:-2] + "в" + w[-1]
    return _rewrite(w)


# register rewritten spellings so lookups after cluster simplification
# still hit (здравствуйте -> здраствуйте), plus stress for the
# genitive/special rewrites; build a stem table for inflected forms
for _k in list(_STRESS):
    _STRESS.setdefault(_rewrite(_k), _STRESS[_k])
for _k, _v in {"ево": 2, "нево": 2, "чево": 2, "ничево": 3,
               "никово": 3, "ково": 2, "тово": 2, "всево": 2,
               "севодня": 2, "свидания": 2}.items():
    _STRESS[_k] = _v

_STEMS = {}
for _k, _v in _STRESS.items():
    if len(_k) > 4:
        _STEMS.setdefault(_k[:-2], _v)


def _stem_stress(w: str):
    """Longest-prefix stem match for out-of-lexicon inflected forms
    (красивого -> красив- -> stress 2)."""
    for k in range(len(w) - 1, 2, -1):
        v = _STEMS.get(w[:k])
        if v is not None:
            return v
    return None


class RussianG2P:
    """EspeakG2P-interface Russian G2P: phonemize(text) -> per-clause
    codepoint lists with the clause punctuation appended."""

    def __init__(self, voice: str = "ru"):
        if not voice.startswith("ru"):
            raise ValueError(f"RussianG2P handles ru voices, got {voice}")
        self.voice = voice

    # --- single word -> IPA segments ------------------------------------

    def word_segments(self, word: str) -> List[str]:
        w = _normalize_word(word)
        if not w:
            return []
        segs: List[str] = []
        vowel_pos: List[int] = []      # seg index of each vowel nucleus
        stressed_nucleus: Optional[int] = None  # index into vowel_pos
        n = len(w)

        def soft_prev():
            """Palatalize the previous consonant (ʲ)."""
            if segs and segs[-1] in set(_CONS.values()) | {"ɡ"}:
                segs[-1] = segs[-1] + "ʲ"

        for i, c in enumerate(w):
            nxt = w[i + 1] if i + 1 < n else ""
            prev = w[i - 1] if i > 0 else ""
            if c in _PLAIN_V:
                hard_i = c == "и" and prev and prev in "жшц"
                if c == "и" and not hard_i:
                    soft_prev()  # BEFORE appending the vowel
                vowel_pos.append(len(segs))
                segs.append("ɨ" if hard_i else _PLAIN_V[c])
            elif c in _SOFT_V:
                base = _SOFT_V[c]
                j_onset = (i == 0 or prev in _VOWEL_LETTERS
                           or prev in "ьъ")
                if j_onset:
                    segs.append("j")
                elif prev in "жшц":
                    if c == "е":
                        base = "ɛ"  # же/ше/це -> hard ɛ
                else:
                    soft_prev()
                vowel_pos.append(len(segs))
                segs.append(base)
                if c == "ё":
                    stressed_nucleus = len(vowel_pos) - 1
            elif c in _HARD:
                segs.append(_HARD[c])
            elif c in _SOFT_ONLY:
                segs.append(_SOFT_ONLY[c])
            elif c in _CONS:
                segs.append(_CONS[c])
            elif c == "й":
                segs.append("j")
            elif c == "ь":
                soft_prev()
            # ъ: separator only, handled via j_onset above

        if not vowel_pos:
            return segs

        # --- stress ------------------------------------------------------
        if stressed_nucleus is None:
            lex = _STRESS.get(w)
            if lex is None:
                lex = _stem_stress(w)
            if lex is not None and 1 <= lex <= len(vowel_pos):
                stressed_nucleus = lex - 1
            elif len(vowel_pos) == 1:
                stressed_nucleus = 0
            else:
                # documented fallback for out-of-lexicon words
                stressed_nucleus = len(vowel_pos) - 2

        # --- vowel reduction (akanye/ikanye) -----------------------------
        for k, pos in enumerate(vowel_pos):
            if k == stressed_nucleus:
                continue
            v = segs[pos]
            # strong reduction slot: immediately pretonic, or the vowel
            # IS word-initial (no onset) — akanye's absolute-initial rule
            pretonic = (k == stressed_nucleus - 1) or (pos == 0)
            if v in ("o", "a"):
                segs[pos] = "ɐ" if pretonic else "ə"
            elif v in ("e", "ɛ"):
                segs[pos] = "ɪ"
        # unstressed я (a after soft consonant) -> ɪ
        for k, pos in enumerate(vowel_pos):
            if k == stressed_nucleus:
                continue
            if segs[pos] in ("ɐ", "ə") and pos > 0 and (
                    segs[pos - 1].endswith("ʲ")
                    or segs[pos - 1] in ("tɕ", "ɕ", "j")):
                segs[pos] = "ɪ"

        # --- final devoicing + regressive assimilation -------------------
        for k in range(len(segs) - 1, -1, -1):
            s_ = segs[k]
            bare = s_.rstrip("ʲ")
            if bare in IPA_VOWELS:
                break
            if bare in _DEVOICE:
                segs[k] = _DEVOICE[bare] + ("ʲ" if s_.endswith("ʲ") else "")
            else:
                break
        for k in range(len(segs) - 2, -1, -1):
            s_ = segs[k]
            bare = s_.rstrip("ʲ")
            nxt_bare = segs[k + 1].rstrip("ʲ")
            if bare in _DEVOICE and nxt_bare in _VOICELESS:
                segs[k] = _DEVOICE[bare] + ("ʲ" if s_.endswith("ʲ") else "")
            elif bare in _VOICE and nxt_bare in set(_DEVOICE) - {"v"}:
                # voiceless voices before voiced obstruent (except в)
                segs[k] = _VOICE[bare] + ("ʲ" if s_.endswith("ʲ") else "")

        segs[vowel_pos[stressed_nucleus]] = (
            "ˈ" + segs[vowel_pos[stressed_nucleus]]
        )
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
