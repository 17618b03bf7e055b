"""Self-contained number verbalization (English + Chinese).

Replaces the reference's `inflect` / `cn2an` dependencies
(ref: zipvoice/tokenizer/normalizer.py:4-5) with dependency-free
implementations producing the same style of output:

* English follows inflect.number_to_words conventions used at
  normalizer.py:122-142 (group commas, hyphenated tens, andword="",
  group=2 year style with zero="oh");
* Chinese follows cn2an "an2cn" conventions (万/亿 grouping, 点 decimals).
"""

from __future__ import annotations

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    # inflect's scale ladder; beyond the last entry numbers verbalize
    # digit-by-digit instead of crashing (a 16+-digit id in text previously
    # raised IndexError and the tokenizer silently DROPPED the EN segment)
    (10**33, "decillion"),
    (10**30, "nonillion"),
    (10**27, "octillion"),
    (10**24, "septillion"),
    (10**21, "sextillion"),
    (10**18, "quintillion"),
    (10**15, "quadrillion"),
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int, zero: str = "zero") -> str:
    if n == 0:
        return zero
    if n < 20:
        return _UNITS[n]
    tens, unit = divmod(n, 10)
    return _TENS[tens] + ("-" + _UNITS[unit] if unit else "")


def _three_digits(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_UNITS[hundreds] + " hundred")
    if rest:
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n: int) -> str:
    """Integer -> English words, inflect style with group commas and
    andword='' (the reference's plain-number call, ref normalizer.py:142):
    1234567 -> 'one million, two hundred thirty-four thousand,
    five hundred sixty-seven'."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n == 0:
        return "zero"
    if n >= 1000 * _SCALES[0][0]:
        # beyond the scale ladder: read digit-by-digit, never crash
        return " ".join(_UNITS[int(d)] for d in str(n))
    parts = []
    for scale, name in _SCALES:
        if n >= scale:
            count, n = divmod(n, scale)
            parts.append(_three_digits(count) + " " + name)
    if n:
        parts.append(_three_digits(n))
    return ", ".join(parts)


def _three_digits_and(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    if hundreds and rest:
        return _UNITS[hundreds] + " hundred and " + _two_digits(rest)
    if hundreds:
        return _UNITS[hundreds] + " hundred"
    return _two_digits(rest)


def number_to_words_and(n: int) -> str:
    """inflect's DEFAULT andword='and' rendering — the convention the
    reference hits on ordinals and fraction denominators (it passes the
    matched string to number_to_words without andword='', ref
    normalizer.py:76-83, 121-122): 101 -> 'one hundred and one',
    1001 -> 'one thousand and one', 2101 -> 'two thousand, one hundred
    and one'."""
    if n < 0:
        return "minus " + number_to_words_and(-n)
    if n == 0:
        return "zero"
    if n >= 1000 * _SCALES[0][0]:
        return " ".join(_UNITS[int(d)] for d in str(n))
    parts = []
    for scale, name in _SCALES:
        if n >= scale:
            count, n = divmod(n, scale)
            parts.append(_three_digits_and(count) + " " + name)
    if n:
        if parts and n < 100:
            return ", ".join(parts) + " and " + _two_digits(n)
        parts.append(_three_digits_and(n))
    return ", ".join(parts)


def number_to_words_year(n: int) -> str:
    """Two-digit-grouped reading with 'oh' for zero digits:
    1905 -> 'nineteen oh five' (inflect group=2, zero='oh')."""
    hi, lo = divmod(n, 100)
    lo_words = _two_digits(lo, zero="oh")
    if 0 < lo < 10:
        lo_words = "oh " + lo_words  # leading zero digit is pronounced
    return _two_digits(hi, zero="oh") + " " + lo_words


def ordinalize_words(words: str) -> str:
    """'twenty-five' -> 'twenty-fifth'; 'twenty' -> 'twentieth'."""
    # ordinalize only the final word/hyphen-part
    def ord_word(w: str) -> str:
        if w in _ORDINAL_IRREGULAR:
            return _ORDINAL_IRREGULAR[w]
        if w.endswith("y"):
            return w[:-1] + "ieth"
        return w + "th"

    if "-" in words.split(" ")[-1]:
        head, _, last = words.rpartition("-")
        return head + "-" + ord_word(last)
    head, _, last = words.rpartition(" ")
    return (head + " " if head else "") + ord_word(last)


def number_to_ordinal_words(n: int) -> str:
    """Ordinal words with inflect's default andword (ref _expand_ordinal
    passes '101st' to number_to_words -> 'one hundred and first')."""
    return ordinalize_words(number_to_words_and(n))


# ---------------------------------------------------------------------------
# Chinese
# ---------------------------------------------------------------------------

_CN_DIGITS = "零一二三四五六七八九"
_CN_UNITS = ["", "十", "百", "千"]
_CN_GROUPS = ["", "万", "亿", "万亿"]


def _cn_four_digits(n: int) -> str:
    """0 < n < 10000 -> Chinese, with interior zeros collapsed."""
    s = ""
    zero_pending = False
    for pos in range(3, -1, -1):
        d = (n // 10**pos) % 10
        if d == 0:
            if s:
                zero_pending = True
            continue
        if zero_pending:
            s += "零"
            zero_pending = False
        s += _CN_DIGITS[d] + _CN_UNITS[pos]
    return s


_CN_DIGITS_PLAIN = "零一二三四五六七八九"


def int_to_chinese(n: int) -> str:
    """Integer -> Chinese numerals, cn2an style: 10500 -> 一万零五百.

    Values at/beyond 10^16 exceed the 万/亿/万亿 group names (and are
    read digit-by-digit in practice — long IDs, phone-number-like
    strings), so they verbalize per digit instead of raising."""
    if n < 0:
        return "负" + int_to_chinese(-n)
    if n == 0:
        return "零"
    if n >= 10 ** 16:
        return "".join(_CN_DIGITS_PLAIN[int(d)] for d in str(n))
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    s = ""
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        part = _cn_four_digits(g)
        # needs a leading 零 if a higher group exists and this group < 1000
        if s and g < 1000:
            s += "零"
        s += part + _CN_GROUPS[i]
    # cn2an writes 一十X as 十X for 10..19
    if s.startswith("一十"):
        s = s[1:]
    return s


def digits_to_chinese(s: str) -> str:
    """Digit-by-digit reading with 零 (cn2an date style: '2018' -> 二零一八)."""
    return "".join(_CN_DIGITS[int(d)] for d in s)


def decimal_to_chinese(int_part: str, frac_part: str) -> str:
    out = int_to_chinese(int(int_part)) + "点"
    out += "".join(_CN_DIGITS[int(d)] for d in frac_part)
    return out
