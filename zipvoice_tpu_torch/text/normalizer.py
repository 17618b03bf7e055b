"""Text normalizers (EN abbreviation/number expansion, ZH digit conversion).

Behavioral rebuild of ref zipvoice/tokenizer/normalizer.py with the
third-party number engines replaced by zipvoice_tpu_torch.text.numbers.
"""

from __future__ import annotations

import re

from zipvoice_tpu_torch.text.numbers import (
    decimal_to_chinese,
    digits_to_chinese,
    int_to_chinese,
    number_to_ordinal_words,
    number_to_words,
    number_to_words_and,
    number_to_words_year,
)

_ABBREVIATIONS = [
    (re.compile(r"\b%s\b" % pat, re.IGNORECASE), rep)
    for pat, rep in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
        ("etc", "et cetera"),
        ("btw", "by the way"),
    ]
]


class EnglishTextNormalizer:
    """Tacotron-style EN normalization (ref normalizer.py:17-158)."""

    _comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
    _decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
    _percent_number_re = re.compile(r"([0-9\.\,]*[0-9]+%)")
    _pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
    _dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
    _fraction_re = re.compile(r"([0-9]+)/([0-9]+)")
    _ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
    _number_re = re.compile(r"[0-9]+")

    def normalize(self, text: str) -> str:
        text = self.expand_abbreviations(text)
        text = self.normalize_numbers(text)
        return text

    def expand_abbreviations(self, text: str) -> str:
        for regex, replacement in _ABBREVIATIONS:
            text = re.sub(regex, replacement, text)
        return text

    def _fraction_to_words(self, numerator: int, denominator: int) -> str:
        # the reference's fraction path calls inflect WITHOUT andword=''
        # (ref normalizer.py:76-83), so numerators/denominators >= 101 keep
        # inflect's default 'and' ('one hundred and one halves')
        if numerator == 1 and denominator == 2:
            return " one half "
        if numerator == 1 and denominator == 4:
            return " one quarter "
        if denominator == 2:
            return " " + number_to_words_and(numerator) + " halves "
        if denominator == 4:
            return " " + number_to_words_and(numerator) + " quarters "
        return (
            " "
            + number_to_words_and(numerator)
            + " "
            + number_to_ordinal_words(denominator)
            + " "
        )

    def _expand_dollars(self, m: re.Match) -> str:
        match = m.group(1)
        parts = match.split(".")
        if len(parts) > 2:
            return " " + match + " dollars "
        dollars = int(parts[0]) if parts[0] else 0
        cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        if dollars and cents:
            d_unit = "dollar" if dollars == 1 else "dollars"
            c_unit = "cent" if cents == 1 else "cents"
            return f" {dollars} {d_unit}, {cents} {c_unit} "
        if dollars:
            return f" {dollars} {'dollar' if dollars == 1 else 'dollars'} "
        if cents:
            return f" {cents} {'cent' if cents == 1 else 'cents'} "
        return " zero dollars "

    def _expand_number(self, m: re.Match) -> str:
        num = int(m.group(0))
        if 1000 < num < 3000:
            if num == 2000:
                return " two thousand "
            if 2000 < num < 2010:
                return " two thousand " + number_to_words(num % 100) + " "
            if num % 100 == 0:
                return " " + number_to_words(num // 100) + " hundred "
            return " " + number_to_words_year(num) + " "
        return " " + number_to_words(num) + " "

    def normalize_numbers(self, text: str) -> str:
        text = re.sub(self._comma_number_re, lambda m: m.group(1).replace(",", ""), text)
        text = re.sub(self._pounds_re, r"\1 pounds", text)
        text = re.sub(self._dollars_re, self._expand_dollars, text)
        text = re.sub(
            self._fraction_re,
            lambda m: self._fraction_to_words(int(m.group(1)), int(m.group(2))),
            text,
        )
        text = re.sub(
            self._decimal_number_re, lambda m: m.group(1).replace(".", " point "), text
        )
        text = re.sub(
            self._percent_number_re, lambda m: m.group(1).replace("%", " percent "), text
        )
        text = re.sub(
            self._ordinal_re,
            lambda m: " " + number_to_ordinal_words(int(m.group(0)[:-2])) + " ",
            text,
        )
        text = re.sub(self._number_re, self._expand_number, text)
        return text


class ChineseTextNormalizer:
    """ZH digit -> hanzi conversion (ref normalizer.py:161-170 calls
    cn2an.transform(text, 'an2cn'), whose smart mode also covers dates,
    percentages and negatives — reproduced here)."""

    _year_re = re.compile(r"([0-9]{2,4})(年)")
    _percent_re = re.compile(r"([0-9]+(?:\.[0-9]+)?)%")
    _negative_re = re.compile(r"-([0-9]+(?:\.[0-9]+)?)")
    _decimal_re = re.compile(r"([0-9]+)\.([0-9]+)")
    _int_re = re.compile(r"[0-9]+")

    def _num_words(self, s: str) -> str:
        if "." in s:
            a, b = s.split(".", 1)
            return decimal_to_chinese(a, b)
        return int_to_chinese(int(s))

    def normalize(self, text: str) -> str:
        # cn2an date mode: the year reads digit-by-digit (2018年 -> 二零一八年)
        text = re.sub(
            self._year_re,
            lambda m: digits_to_chinese(m.group(1)) + m.group(2),
            text,
        )
        # percentages: 3.5% -> 百分之三点五
        text = re.sub(
            self._percent_re,
            lambda m: "百分之" + self._num_words(m.group(1)),
            text,
        )
        # negatives: -5 -> 负五
        text = re.sub(
            self._negative_re,
            lambda m: "负" + self._num_words(m.group(1)),
            text,
        )
        text = re.sub(
            self._decimal_re,
            lambda m: decimal_to_chinese(m.group(1), m.group(2)),
            text,
        )
        text = re.sub(self._int_re, lambda m: int_to_chinese(int(m.group(0))), text)
        return text
