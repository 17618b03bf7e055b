"""Tokenizers: text -> phoneme/char tokens -> ids.

The PyTorch port's copy of the reference package's front ends: the same
five tokenizer flavors (simple / espeak / emilia / dialog / libritts), the
same tokens.txt contract ('{token}\\t{id}' lines, '_' = pad), the same
language segmentation and pinyin escapes ('<pinyin>') / tags ('[S1]').

G2P backends are host-side and optional, tried in this order:
* espeak: piper_phonemize if importable, else an ``espeak-ng`` subprocess,
  else (English only) the offline lexicon-and-rules G2P in text/en_g2p.py,
  else ``G2PUnavailableError``;
* hanzi->pinyin: jieba, then pypinyin if importable, else the offline
  reading table in text/pinyin_data.py; without jieba,
  ``G2PUnavailableError``.  The initial/final split is rule-based and
  needs no dictionary.
"""

from __future__ import annotations

import logging
import re
import shutil
import subprocess
from typing import Dict, List, Optional

from zipvoice_tpu_torch.text.normalizer import (
    ChineseTextNormalizer,
    EnglishTextNormalizer,
)


class G2PUnavailableError(RuntimeError):
    pass


# piper keeps clause punctuation as tokens (see text/espeak_map.py ids 4-13)
_CLAUSE_PUNCT = ".,;:!?"
_CLAUSE_SPLIT = re.compile(r"([.,;:!?…])")
_LANG_SWITCH = re.compile(r"\([a-z]{2,3}(?:-[a-z0-9-]+)?\)")  # (en)/(zh)/…


def shape_espeak_clauses(clause_ipas: List[str], puncts: List[str]) -> List[str]:
    """Raw espeak IPA per clause + trailing punctuation -> the
    piper_phonemize token stream: one token per unicode char, a single
    space token between words, the clause punctuation appended directly
    after its clause, a space before the next clause (ref tokenizer.py:
    158-165, 321-329 consume exactly this shape).

    Also strips espeak artifacts piper never emits: language-switch
    markers, tie bars (U+0361), ZWJ, and newlines-as-clause-breaks.
    """
    tokens: List[str] = []
    n = max(len(clause_ipas), len(puncts))
    for i in range(n):
        ipa = clause_ipas[i] if i < len(clause_ipas) else ""
        punct = puncts[i] if i < len(puncts) else ""
        ipa = _LANG_SWITCH.sub("", ipa)
        ipa = ipa.replace("͡", "").replace("‍", "")
        ipa = " ".join(ipa.split())  # newlines + runs of spaces -> one space
        if not ipa and not punct:
            continue
        if tokens and ipa:
            tokens.append(" ")
        tokens.extend(list(ipa))
        if punct:
            # piper's map has no ellipsis token; espeak treats it as a period
            tokens.append("." if punct == "…" else punct)
    return tokens


def _espeak_binary_phonemize(exe: str, text: str, lang: str) -> List[str]:
    """Subprocess fallback shaped to piper_phonemize token semantics."""
    parts = _CLAUSE_SPLIT.split(text)
    clauses = parts[::2]
    puncts = parts[1::2]
    ipas = []
    for clause in clauses:
        if not clause.strip():
            ipas.append("")
            continue
        res = subprocess.run(
            [exe, "-q", "--ipa", "-v", lang, "--", clause.strip()],
            capture_output=True, text=True, check=True,
        )
        ipas.append(res.stdout.strip())
    return shape_espeak_clauses(ipas, puncts)


def active_g2p_backend(lang: str = "en-us") -> str:
    """Which G2P backend espeak_phonemize would use for ``lang``:
    'piper', 'espeak-ng', 'offline-fallback' (EN only), or 'none'.
    Exposed so golden pinning can record the provenance of EN goldens
    produced by the vendored fallback."""
    try:
        from piper_phonemize import phonemize_espeak  # type: ignore  # noqa: F401

        return "piper"
    except ImportError:
        pass
    if shutil.which("espeak-ng") or shutil.which("espeak"):
        return "espeak-ng"
    if lang.lower().startswith("en"):
        return "offline-fallback"
    return "none"


def espeak_phonemize(text: str, lang: str = "en-us") -> List[str]:
    """IPA phonemization via piper_phonemize or the espeak-ng binary.

    Both backends run the same espeak engine; the subprocess path reshapes
    espeak's plain --ipa output into piper's per-char token stream
    (punctuation/space tokens included) so token ids match either way.

    When NEITHER is installed, English falls back to the vendored offline
    lexicon+rules G2P (text/en_g2p.py) — same token inventory and stream
    shape, different engine; callers that pin goldens must record the
    provenance via active_g2p_backend().  Non-EN languages still raise.
    """
    # single source of truth: dispatch on active_g2p_backend so the
    # recorded provenance can never drift from the engine actually used
    backend = active_g2p_backend(lang)
    if backend == "piper":
        from piper_phonemize import phonemize_espeak  # type: ignore

        out = phonemize_espeak(text, lang)
        return [ph for sent in out for ph in sent]
    if backend == "espeak-ng":
        exe = shutil.which("espeak-ng") or shutil.which("espeak")
        return _espeak_binary_phonemize(exe, text, lang)
    if backend == "offline-fallback":
        from zipvoice_tpu_torch.text.en_g2p import fallback_phonemize

        return fallback_phonemize(text)
    raise G2PUnavailableError(
        "No espeak G2P backend: install piper_phonemize or espeak-ng"
        f" (offline fallback covers EN only, not {lang!r})"
    )


def hanzi_to_pinyin(text: str) -> List[str]:
    """hanzi -> tone3 pinyin list (ref tokenizer.py:298-307).

    Prefers jieba+pypinyin (the reference's stack); falls back to the
    vendored reading table in text/pinyin_data.py so ZH works offline
    (common-reading approximation with word overrides + tone sandhi)."""
    try:
        import jieba
    except ImportError as ex:
        raise G2PUnavailableError(f"jieba unavailable: {ex}") from ex
    segs = list(jieba.cut(text))
    try:
        from pypinyin import Style, lazy_pinyin  # type: ignore

        return lazy_pinyin(
            segs, style=Style.TONE3, tone_sandhi=True,
            neutral_tone_with_five=True,
        )
    except ImportError:
        from zipvoice_tpu_torch.text.pinyin_data import lazy_pinyin_fallback

        return lazy_pinyin_fallback(segs)


# --- rule-based pinyin initial/final split (pypinyin strict=False semantics) -

_PINYIN_INITIALS_2 = ("zh", "ch", "sh")
_PINYIN_INITIALS_1 = tuple("bpmfdtnlgkhjqxrzcsyw")


def split_pinyin(pinyin_tone3: str) -> List[str]:
    """'zhong1' -> ['zh0', 'ong1'].

    Initials get a trailing '0' so they never collide with espeak IPA tokens
    (ref tokenizer.py:348-367).  Input must be tone3 style: letters + tone
    digit 1-5.
    """
    body, tone = pinyin_tone3[:-1], pinyin_tone3[-1]
    if body.startswith(_PINYIN_INITIALS_2):
        initial, final = body[:2], body[2:]
    elif body.startswith(_PINYIN_INITIALS_1):
        initial, final = body[:1], body[1:]
    else:
        initial, final = "", body
    out = []
    if initial:
        out.append(initial + "0")
    if final:
        out.append(final + tone)
    return out


def is_valid_tone3_pinyin(s: str) -> bool:
    return len(s) >= 2 and s[:-1].isalpha() and s[-1] in "12345"


# ---------------------------------------------------------------------------


def read_token_file(token_file: str) -> Dict[str, int]:
    token2id: Dict[str, int] = {}
    with open(token_file, encoding="utf-8") as f:
        for line in f:
            info = line.rstrip("\n").split("\t")
            token, idx = info[0], int(info[1])
            if token in token2id:
                raise ValueError(f"{token_file}: duplicate token {token!r}")
            token2id[token] = idx
    return token2id


def write_token_file(token2id: Dict[str, int], path: str):
    with open(path, "w", encoding="utf-8") as f:
        for token, idx in sorted(token2id.items(), key=lambda kv: kv[1]):
            f.write(f"{token}\t{idx}\n")


class Tokenizer:
    """Base: tokens.txt mapping + id conversion (OOV tokens are skipped)."""

    def __init__(self, token_file: Optional[str] = None):
        self.has_tokens = False
        self.token2id: Dict[str, int] = {}
        if token_file is not None:
            self.token2id = read_token_file(token_file)
            self.pad_id = self.token2id["_"]
            self.vocab_size = len(self.token2id)
            self.has_tokens = True

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        raise NotImplementedError

    def texts_to_token_ids(self, texts: List[str]) -> List[List[int]]:
        return self.tokens_to_token_ids(self.texts_to_tokens(texts))

    def tokens_to_token_ids(self, tokens_list: List[List[str]]) -> List[List[int]]:
        if not self.has_tokens:
            raise ValueError("Tokenizer needs a tokens file to map to ids.")
        out = []
        for tokens in tokens_list:
            ids = []
            for t in tokens:
                if t not in self.token2id:
                    logging.debug("Skip OOV %s", t)
                    continue
                ids.append(self.token2id[t])
            out.append(ids)
        return out


class SimpleTokenizer(Tokenizer):
    """Character tokenizer, no normalization (ref tokenizer.py:63-124)."""

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        return [list(t) for t in texts]


class EspeakTokenizer(Tokenizer):
    """Espeak G2P tokenizer for any espeak language (ref tokenizer.py:127-198)."""

    def __init__(self, token_file: Optional[str] = None, lang: str = "en-us"):
        super().__init__(token_file)
        self.lang = lang

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        out = []
        for t in texts:
            try:
                out.append(espeak_phonemize(t, self.lang))
            except G2PUnavailableError:
                raise
            except Exception as ex:  # noqa: BLE001 — mirror ref fail-soft
                logging.warning("Tokenization of %s failed: %s", self.lang, ex)
                out.append([])
        return out


_PUNCT_MAP = [
    ("，", ","), ("。", "."), ("！", "!"), ("？", "?"), ("；", ";"),
    ("：", ":"), ("、", ","), ("‘", "'"), ("“", '"'), ("”", '"'),
    ("’", "'"), ("⋯", "…"), ("···", "…"), ("・・・", "…"), ("...", "…"),
]

_PART_PATTERN = re.compile(r"[<[].*?[>\]]|.")
_SPECIAL_SPLIT = re.compile(r"([<[].*?[>\]])")


class EmiliaTokenizer(Tokenizer):
    """Bilingual ZH/EN phone tokenizer with language segmentation, pinyin
    escapes <...> and special tags [...] (ref tokenizer.py:201-499)."""

    def __init__(self, token_file: Optional[str] = None, token_type: str = "phone"):
        if token_type != "phone":
            raise ValueError(f"unsupported emilia token_type {token_type!r}")
        super().__init__(token_file)
        self.en_normalizer = EnglishTextNormalizer()
        self.zh_normalizer = ChineseTextNormalizer()

    # -- text preprocessing

    def preprocess_text(self, text: str) -> str:
        return self.map_punctuations(text)

    @staticmethod
    def map_punctuations(text: str) -> str:
        for a, b in _PUNCT_MAP:
            text = text.replace(a, b)
        return text

    # -- segmentation

    @staticmethod
    def _is_chinese(ch: str) -> bool:
        return "一" <= ch <= "龥"

    @staticmethod
    def _is_alphabet(ch: str) -> bool:
        return ("A" <= ch <= "Z") or ("a" <= ch <= "z")

    @staticmethod
    def _is_pinyin(part: str) -> bool:
        return part.startswith("<") and part.endswith(">")

    @staticmethod
    def _is_tag(part: str) -> bool:
        return part.startswith("[") and part.endswith("]")

    def get_segment(self, text: str) -> List[tuple]:
        """Greedy run segmentation by char language; 'other' chars attach to
        the running segment (ref tokenizer.py:387-446)."""
        parts = _PART_PATTERN.findall(text)
        types = []
        for p in parts:
            if self._is_chinese(p) or self._is_pinyin(p):
                types.append("zh")
            elif self._is_alphabet(p):
                types.append("en")
            else:
                types.append("other")

        segments: List[tuple] = []
        seg, lang = "", ""
        for i, (p, ty) in enumerate(zip(parts, types)):
            if i == 0:
                seg, lang = p, ty
            elif lang == "other":
                seg += p
                lang = ty
            elif ty in (lang, "other"):
                seg += p
            else:
                segments.append((seg, lang))
                seg, lang = p, ty
        if seg or not segments:
            segments.append((seg, lang))
        return self._split_special(segments)

    def _split_special(self, segments: List[tuple]) -> List[tuple]:
        result = []
        for seg, lang in segments:
            for part in _SPECIAL_SPLIT.split(seg):
                if not part:
                    continue
                if self._is_pinyin(part):
                    result.append((part, "pinyin"))
                elif self._is_tag(part):
                    result.append((part, "tag"))
                else:
                    result.append((part, lang))
        return result

    # -- per-language tokenization

    def tokenize_zh(self, text: str) -> List[str]:
        try:
            text = self.zh_normalizer.normalize(text)
            phones: List[str] = []
            for py in hanzi_to_pinyin(text):
                if is_valid_tone3_pinyin(py):
                    phones.extend(split_pinyin(py))
                else:
                    phones.append(py)
            return phones
        except G2PUnavailableError:
            raise
        except Exception as ex:  # noqa: BLE001
            logging.warning("Tokenization of Chinese texts failed: %s", ex)
            return []

    def tokenize_en(self, text: str) -> List[str]:
        try:
            text = self.en_normalizer.normalize(text)
            return espeak_phonemize(text, "en-us")
        except G2PUnavailableError:
            raise
        except Exception as ex:  # noqa: BLE001
            logging.warning("Tokenization of English texts failed: %s", ex)
            return []

    def tokenize_pinyin(self, part: str) -> List[str]:
        body = part[1:-1]
        if not is_valid_tone3_pinyin(body):
            logging.warning("<%s> is not valid tone3 pinyin; skipped", body)
            return []
        return split_pinyin(body)

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        out = []
        for text in texts:
            text = self.preprocess_text(text)
            phones: List[str] = []
            for seg, lang in self.get_segment(text):
                if lang == "zh":
                    phones += self.tokenize_zh(seg)
                elif lang == "en":
                    phones += self.tokenize_en(seg)
                elif lang == "pinyin":
                    phones += self.tokenize_pinyin(seg)
                elif lang == "tag":
                    phones += [seg]
                else:
                    logging.warning("Skipping unknown-language segment: %r", seg)
            out.append(phones)
        return out


class DialogTokenizer(EmiliaTokenizer):
    """Two-party dialog tokenizer with [S1]/[S2] speaker-turn tokens
    (ref tokenizer.py:502-515)."""

    def __init__(self, token_file: Optional[str] = None, token_type: str = "phone"):
        super().__init__(token_file, token_type)
        if token_file:
            self.spk_a_id = self.token2id["[S1]"]
            self.spk_b_id = self.token2id["[S2]"]

    def preprocess_text(self, text: str) -> str:
        text = re.sub(r"\s*(\[S[12]\])\s*", r"\1", text)
        return self.map_punctuations(text)


class LibriTTSTokenizer(Tokenizer):
    """char / phone / bpe tokenizer with tacotron cleaning
    (ref tokenizer.py:518-611)."""

    def __init__(self, token_file: Optional[str] = None, token_type: str = "char"):
        if token_type not in ("bpe", "char", "phone"):
            raise ValueError(f"unsupported libritts token_type {token_type!r}")
        self.type = token_type
        self.en_normalizer = EnglishTextNormalizer()
        if token_type == "bpe":
            self.has_tokens = False
            if token_file is not None:
                try:
                    import sentencepiece as spm  # optional dep

                    self.sp = spm.SentencePieceProcessor()
                    self.sp.load(token_file)
                except ImportError:
                    # vendored pure-Python reader (same .model files)
                    from zipvoice_tpu_torch.text.spm import SentencePieceEncoder

                    self.sp = SentencePieceEncoder(token_file)
                self.pad_id = self.sp.piece_to_id("<pad>")
                self.vocab_size = self.sp.get_piece_size()
                self.has_tokens = True
        else:
            super().__init__(token_file)

    # espnet tacotron_cleaner abbreviations: the pattern REQUIRES a trailing
    # dot ('mr.' expands, bare 'mr' does not) — unlike the Emilia
    # normalizer's \b-delimited list
    _CLEANER_ABBREV = [
        (re.compile(r"\b%s\." % p, re.IGNORECASE), r)
        for p, r in [
            ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
            ("st", "saint"), ("co", "company"), ("jr", "junior"),
            ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
            ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
            ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
            ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
        ]
    ]

    def normalize(self, text: str) -> str:
        """espnet tacotron_cleaner.cleaners.custom_english_cleaners, which
        the reference uses verbatim (ref tokenizer.py:534): ascii fold,
        lowercase, number expansion, dot-suffixed abbreviations, symbol
        expansion (';'/':' -> ',', '-' -> ' ', '&' -> 'and'), removal of
        ()[]<>\" symbols, uppercase, whitespace collapse."""
        import unicodedata

        text = (
            unicodedata.normalize("NFKD", text)
            .encode("ascii", "ignore")
            .decode()
        )
        text = text.lower()
        text = self.en_normalizer.normalize_numbers(text)
        for regex, rep in self._CLEANER_ABBREV:
            text = re.sub(regex, rep, text)
        text = (text.replace(";", ",").replace(":", ",")
                .replace("-", " ").replace("&", "and"))
        text = re.sub(r'[\(\)\[\]\<\>\"]+', "", text)
        # our number expansion pads with spaces (tacotron's does not);
        # re-attach punctuation so 'TWO ,' reads 'TWO,' like the reference
        text = re.sub(r" +([,.!?])", r"\1", text)
        text = text.upper()
        return re.sub(r"\s+", " ", text).strip()

    def texts_to_tokens(self, texts: List[str]) -> List[List[str]]:
        texts = [self.normalize(t) for t in texts]
        if self.type == "char":
            return [list(t) for t in texts]
        if self.type == "phone":
            return [espeak_phonemize(t.lower(), "en-us") for t in texts]
        return self.sp.encode(texts, out_type=str)

    def texts_to_token_ids(self, texts: List[str]) -> List[List[int]]:
        if self.type == "bpe":
            return self.sp.encode([self.normalize(t) for t in texts])
        return self.tokens_to_token_ids(self.texts_to_tokens(texts))


def get_tokenizer(name: str, token_file: Optional[str] = None, lang: str = "en-us",
                  token_type: str = "phone"):
    """Named tokenizer factory (ref tokenizer.py:614-626 add_tokens dispatch)."""
    if name == "emilia":
        return EmiliaTokenizer(token_file)
    if name == "espeak":
        return EspeakTokenizer(token_file, lang=lang)
    if name == "dialog":
        return DialogTokenizer(token_file)
    if name == "libritts":
        return LibriTTSTokenizer(token_file, token_type=token_type)
    if name == "simple":
        return SimpleTokenizer(token_file)
    raise ValueError(f"Unsupported tokenizer: {name}")
