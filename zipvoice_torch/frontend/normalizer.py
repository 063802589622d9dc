"""Text normalizers (English + Chinese), dependency-free (the port's copy
of ``zipvoice_tpu/frontend/normalizer.py``).

The reference (zipvoice/tokenizer/normalizer.py) uses the ``inflect`` package
for English number expansion and ``cn2an`` for Chinese; neither is a
first-party component, so the number-to-words engines are implemented here
directly with matching output conventions (same regex pipeline, same
abbreviation table, same year/dollar/fraction special cases).
"""

import re
from typing import List

# ---------------------------------------------------------------------------
# English number-to-words (inflect-compatible subset)
# ---------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALE = ["", "thousand", "million", "billion", "trillion", "quadrillion"]

_ORDINAL_MAP = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _below_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    t, o = divmod(n, 10)
    return _TENS[t] + ("-" + _ONES[o] if o else "")


def _below_1000(n: int, andword: str) -> str:
    h, r = divmod(n, 100)
    parts = []
    if h:
        parts.append(_ONES[h] + " hundred")
    if r:
        if h and andword:
            parts.append(andword)
        parts.append(_below_100(r))
    return " ".join(parts)


def number_to_words(n: int, andword: str = "and") -> str:
    """Cardinal words, grouped with commas like inflect:
    1234567 -> 'one million, two hundred and thirty-four thousand, ...'."""
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n == 0:
        return "zero"
    groups: List[int] = []
    while n > 0:
        groups.append(n % 1000)
        n //= 1000
    parts = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        text = _below_1000(g, andword)
        if i > 0:
            text += " " + _SCALE[i]
        parts.append(text)
    return ", ".join(parts)


def ordinal_words(n: int, andword: str = "and") -> str:
    """'21' -> 'twenty-first' (inflect.ordinal(number_to_words(n)))."""
    words = number_to_words(n, andword)
    # ordinalize the last word
    head, sep, last = words.rpartition(" ")
    h2, s2, l2 = last.rpartition("-")
    if l2 in _ORDINAL_MAP:
        l2 = _ORDINAL_MAP[l2]
    elif l2.endswith("y"):
        l2 = l2[:-1] + "ieth"
    else:
        l2 = l2 + "th"
    return head + sep + h2 + s2 + l2


def year_to_words(n: int) -> str:
    """inflect number_to_words(n, group=2, zero='oh', andword='') with
    ', ' collapsed to ' ' (used for 2010..2999 years in the reference)."""
    s = str(n)
    if len(s) % 2:
        s = s[0] + s[1:]
        pairs = [s[:1]] + [s[i : i + 2] for i in range(1, len(s), 2)]
    else:
        pairs = [s[i : i + 2] for i in range(0, len(s), 2)]
    words = []
    for p in pairs:
        v = int(p)
        if len(p) == 2 and p[0] == "0":
            words.append("oh " + _ONES[v] if v else "oh oh")
        elif len(p) == 2 and v % 10 == 0 and v >= 20:
            words.append(_TENS[v // 10])
        else:
            words.append(_below_100(v) if len(p) == 2 else _ONES[v])
    return " ".join(words)


class EnglishTextNormalizer:
    """English normalization pipeline (reference normalizer.py:17-158):
    abbreviation expansion + number/dollar/fraction/ordinal expansion."""

    def __init__(self):
        self._abbreviations = [
            (re.compile("\\b%s\\b" % x[0], re.IGNORECASE), x[1])
            for x in [
                ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
                ("st", "saint"), ("co", "company"), ("jr", "junior"),
                ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
                ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
                ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
                ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
                ("etc", "et cetera"), ("btw", "by the way"),
            ]
        ]
        self._comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
        self._decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
        self._percent_number_re = re.compile(r"([0-9\.\,]*[0-9]+%)")
        self._pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
        self._dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
        self._fraction_re = re.compile(r"([0-9]+)/([0-9]+)")
        self._ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
        self._number_re = re.compile(r"[0-9]+")

    def normalize(self, text: str) -> str:
        text = self.expand_abbreviations(text)
        text = self.normalize_numbers(text)
        return text

    def expand_abbreviations(self, text: str) -> str:
        for regex, replacement in self._abbreviations:
            text = re.sub(regex, replacement, text)
        return text

    def fraction_to_words(self, numerator: int, denominator: int) -> str:
        if numerator == 1 and denominator == 2:
            return " one half "
        if numerator == 1 and denominator == 4:
            return " one quarter "
        if denominator == 2:
            return " " + number_to_words(numerator) + " halves "
        if denominator == 4:
            return " " + number_to_words(numerator) + " quarters "
        return (
            " " + number_to_words(numerator) + " "
            + ordinal_words(denominator) + " "
        )

    def _expand_dollars(self, m):
        match = m.group(1)
        parts = match.split(".")
        if len(parts) > 2:
            return " " + match + " dollars "
        dollars = int(parts[0]) if parts[0] else 0
        cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        if dollars and cents:
            dollar_unit = "dollar" if dollars == 1 else "dollars"
            cent_unit = "cent" if cents == 1 else "cents"
            return " %s %s, %s %s " % (dollars, dollar_unit, cents, cent_unit)
        elif dollars:
            return " %s %s " % (dollars, "dollar" if dollars == 1 else "dollars")
        elif cents:
            return " %s %s " % (cents, "cent" if cents == 1 else "cents")
        return " zero dollars "

    def _expand_number(self, m):
        num = int(m.group(0))
        if num > 1000 and num < 3000:
            if num == 2000:
                return " two thousand "
            elif num > 2000 and num < 2010:
                return " two thousand " + number_to_words(num % 100) + " "
            elif num % 100 == 0:
                return " " + number_to_words(num // 100) + " hundred "
            else:
                return " " + year_to_words(num) + " "
        return " " + number_to_words(num, andword="") + " "

    def normalize_numbers(self, text: str) -> str:
        text = re.sub(self._comma_number_re, lambda m: m.group(1).replace(",", ""), text)
        text = re.sub(self._pounds_re, r"\1 pounds", text)
        text = re.sub(self._dollars_re, self._expand_dollars, text)
        text = re.sub(
            self._fraction_re,
            lambda m: self.fraction_to_words(int(m.group(1)), int(m.group(2))),
            text,
        )
        text = re.sub(
            self._decimal_number_re,
            lambda m: m.group(1).replace(".", " point "),
            text,
        )
        text = re.sub(
            self._percent_number_re,
            lambda m: m.group(1).replace("%", " percent "),
            text,
        )
        text = re.sub(
            self._ordinal_re,
            lambda m: " " + ordinal_words(int(re.sub(r"\D", "", m.group(0)))) + " ",
            text,
        )
        text = re.sub(self._number_re, self._expand_number, text)
        return text


# ---------------------------------------------------------------------------
# Chinese digits -> hanzi (cn2an.transform(text, "an2cn") equivalent)
# ---------------------------------------------------------------------------

_CN_DIGITS = "零一二三四五六七八九"
_CN_UNITS = ["", "十", "百", "千"]
_CN_BIG_UNITS = ["", "万", "亿", "万亿"]


def _int_to_cn(n: int) -> str:
    if n == 0:
        return "零"
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            if parts and not parts[-1].endswith("零"):
                parts.append("零")
            continue
        s = ""
        digits = [int(d) for d in str(g)]
        pad = 4 - len(digits) if gi < len(groups) - 1 else 0
        if pad and parts and not parts[-1].endswith("零"):
            s += "零"
        prev_zero = False
        for i, d in enumerate(digits):
            unit = _CN_UNITS[len(digits) - 1 - i]
            if d == 0:
                prev_zero = True
                continue
            if prev_zero:
                s += "零"
                prev_zero = False
            s += _CN_DIGITS[d] + unit
        s += _CN_BIG_UNITS[gi]
        parts.append(s)
    out = "".join(parts)
    # 一十X -> 十X (10..19)
    if out.startswith("一十"):
        out = out[1:]
    return out


def _decimal_to_cn(int_part: str, frac_part: str) -> str:
    out = _int_to_cn(int(int_part)) + "点"
    out += "".join(_CN_DIGITS[int(d)] for d in frac_part)
    return out


class ChineseTextNormalizer:
    """Converts arabic numbers inside Chinese text to hanzi
    (reference normalizer.py:161-170 via cn2an)."""

    _num_re = re.compile(r"[0-9]+\.[0-9]+|[0-9]+")

    def normalize(self, text: str) -> str:
        def repl(m):
            s = m.group(0)
            if "." in s:
                a, b = s.split(".")
                return _decimal_to_cn(a, b)
            return _int_to_cn(int(s))

        return self._num_re.sub(repl, text)
