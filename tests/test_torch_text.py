"""The port's text front ends against the JAX package's on the CPU: token
strings and ids must be equal exactly.  Covers the pinned token goldens
(emilia, dialog), the number and normalizer batteries, the espeak clause
shaping and the mocked espeak-ng subprocess, the offline English G2P, the
pure-Python sentencepiece (unigram, BPE, byte fallback), libritts, and
Chinese through the offline pinyin table (with jieba).  Every tokens.txt is
built here."""

import json
import re
import sys
from pathlib import Path

import pytest

import zipvoice_tpu.text.tokenizer as jtok
import zipvoice_tpu_torch.text.tokenizer as ttok
from zipvoice_tpu.text import normalizer as jnorm
from zipvoice_tpu.text import numbers as jnum
from zipvoice_tpu.text import spm as jspm
from zipvoice_tpu_torch.text import normalizer as tnorm
from zipvoice_tpu_torch.text import numbers as tnum
from zipvoice_tpu_torch.text import spm as tspm
from zipvoice_tpu_torch.text.espeak_map import VENDORED_ESPEAK_MAP
from zipvoice_tpu_torch.text.pinyin_data import CHAR_PINYIN, WORD_PINYIN

GOLDENS = json.loads((Path(__file__).parent / "fixtures" / "token_goldens.json")
                     .read_text(encoding="utf-8"))
TAGS = ("[S1]", "[S2]", "[laughter]")


def _has_cjk(text: str) -> bool:
    return any("一" <= ch <= "龥" for ch in text)


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    """The espeak block, every initial/final the offline pinyin table can
    emit, and the tags, densely numbered."""
    token2id = dict(VENDORED_ESPEAK_MAP)
    readings = set(CHAR_PINYIN.values()) | {r for rs in WORD_PINYIN.values() for r in rs}
    extra = sorted({p for r in readings for p in ttok.split_pinyin(r)} | set(TAGS))
    for t in extra:
        token2id.setdefault(t, len(token2id))
    path = tmp_path_factory.mktemp("tokens") / "tokens.txt"
    ttok.write_token_file(token2id, str(path))
    return str(path)


@pytest.fixture
def offline_g2p(monkeypatch):
    """No piper and no espeak-ng binary: English takes the offline G2P,
    whatever this machine has installed (the goldens were pinned from it)."""
    monkeypatch.setitem(sys.modules, "piper_phonemize", None)
    monkeypatch.setattr(ttok.shutil, "which", lambda name: None)


GOLDEN_CASES = [(name, text) for name in ("emilia", "dialog")
                for text in GOLDENS[name]]


@pytest.mark.parametrize("name,text", GOLDEN_CASES)
def test_token_goldens_equal_jax(offline_g2p, token_file, name, text):
    if _has_cjk(text):
        pytest.importorskip("jieba")
    port = ttok.get_tokenizer(name, token_file)
    ref = jtok.get_tokenizer(name, token_file)
    tokens = port.texts_to_tokens([text])[0]
    assert tokens == ref.texts_to_tokens([text])[0] == GOLDENS[name][text]
    ids = port.texts_to_token_ids([text])[0]
    assert ids == ref.texts_to_token_ids([text])[0]
    assert len(ids) == len(tokens)  # every golden token is in the vocabulary


def test_dialog_tokenizer_turn_ids(token_file):
    tok = ttok.get_tokenizer("dialog", token_file)
    ref = jtok.get_tokenizer("dialog", token_file)
    assert (tok.spk_a_id, tok.spk_b_id) == (ref.spk_a_id, ref.spk_b_id)
    assert tok.preprocess_text("hi [S1] there [S2]x") == "hi[S1]there[S2]x"


NUMBERS = [0, 7, 13, 21, 99, 100, 105, 999, 1000, 1001, 1905, 2000, 2005, 2024, 10500,
           123456, 1234567, 10**9 + 7, 2 * 10**15, 10**18, 10**40]


def test_number_battery_equals_jax():
    for n in NUMBERS:
        assert tnum.number_to_words(n) == jnum.number_to_words(n), n
        assert tnum.number_to_words_and(n) == jnum.number_to_words_and(n), n
        assert tnum.number_to_ordinal_words(n) == jnum.number_to_ordinal_words(n), n
        assert tnum.int_to_chinese(n) == jnum.int_to_chinese(n), n
    for y in (1066, 1900, 1905, 1999, 2000, 2005, 2024):
        assert tnum.number_to_words_year(y) == jnum.number_to_words_year(y), y
    assert tnum.number_to_words(1234567) == (
        "one million, two hundred thirty-four thousand, five hundred sixty-seven")


EN_SENTENCES = ["Mr. Smith", "in 1999", "year 2000", "year 2005", "$5", "$1.50", "50%",
                "3.14", "1/2", "3 cats", "1st place", "1,000 items", "the 101st airborne",
                "page 101 follows", "I have 2000000000000000 dollars", "Turn it up to 11.",
                "Dr. Who at 5:30pm on Jan. 3rd, 2021 paid £20."]
ZH_SENTENCES = ["超过90的人", "1.5倍", "2018年5月1日", "涨了3.5%", "涨了12%", "-5度",
                "零下-3.5", "我有25个苹果。"]


def test_normalizer_battery_equals_jax():
    en_t, en_j = tnorm.EnglishTextNormalizer(), jnorm.EnglishTextNormalizer()
    for s in EN_SENTENCES:
        assert en_t.normalize(s) == en_j.normalize(s), s
    zh_t, zh_j = tnorm.ChineseTextNormalizer(), jnorm.ChineseTextNormalizer()
    for s in ZH_SENTENCES:
        assert zh_t.normalize(s) == zh_j.normalize(s), s
    assert re.sub(r"\s+", " ", en_t.normalize("Mr. Smith")).strip() == "mister. Smith"
    assert zh_t.normalize("2018年5月1日") == "二零一八年五月一日"


def test_segmentation_and_pinyin_split_equal_jax():
    port, ref = ttok.EmiliaTokenizer(), jtok.EmiliaTokenizer()
    for text in ("我们是小米人,是吗? Yes I think so!霍...啦啦啦",
                 "超过90%的人<le5>说[S1]hello", "wait...", "你好，世界。"):
        assert port.get_segment(text) == ref.get_segment(text)
        assert port.map_punctuations(text) == ref.map_punctuations(text)
    for py in ("zhong1", "le5", "an4", "yuan2", "chi3", "er2"):
        assert ttok.split_pinyin(py) == jtok.split_pinyin(py)
    assert port.tokenize_pinyin("<junk>") == [] == ref.tokenize_pinyin("<junk>")


def test_shape_espeak_clauses_equals_jax():
    cases = [(["həlˈoʊ", "wˈɜːld"], [",", "."]), (["a\nb"], []), (["ˌæ  bˈiː"], ["?"]),
             (["(en)tʃ͡a"], []), (["ə"], ["…"]), (["", "b"], [",", ""])]
    for ipas, puncts in cases:
        assert ttok.shape_espeak_clauses(ipas, puncts) == \
            jtok.shape_espeak_clauses(ipas, puncts)
    assert ttok.shape_espeak_clauses(["həlˈoʊ", "wˈɜːld"], [",", "."]) == [
        "h", "ə", "l", "ˈ", "o", "ʊ", ",", " ", "w", "ˈ", "ɜ", "ː", "l", "d", "."]


def test_espeak_subprocess_mocked_equals_jax(monkeypatch):
    """The espeak-ng binary path, with the binary mocked: the same token
    stream as the JAX package's, and piper's ids for punctuation."""
    fake_ipa = {"hello": "həlˈoʊ", "world": "wˈɜːld"}

    def fake_run(cmd, capture_output, text, check):
        class R:
            stdout = fake_ipa[cmd[-1]] + "\n"
        return R()

    monkeypatch.setattr(ttok.shutil, "which", lambda name: "/usr/bin/espeak-ng")
    monkeypatch.setattr(ttok.subprocess, "run", fake_run)
    monkeypatch.setitem(sys.modules, "piper_phonemize", None)
    assert ttok.active_g2p_backend("de") == "espeak-ng"
    toks = ttok.espeak_phonemize("hello, world.", "en-us")
    assert toks == jtok.espeak_phonemize("hello, world.", "en-us")
    ids = [VENDORED_ESPEAK_MAP[t] for t in toks]
    assert ids[6] == 8 and ids[7] == 3 and ids[-1] == 10  # , space .


def test_offline_g2p_english_only(offline_g2p):
    assert ttok.active_g2p_backend("en-us") == "offline-fallback"
    assert ttok.active_g2p_backend("de") == "none"
    text = "The 3 quixotic zebras jumped; weren't they extraordinary? Hello world."
    assert ttok.espeak_phonemize(text) == jtok.espeak_phonemize(text)
    assert "".join(ttok.espeak_phonemize("hello")) == "həlˈoʊ"
    with pytest.raises(ttok.G2PUnavailableError):
        ttok.espeak_phonemize("hallo", "de")
    with pytest.raises(ttok.G2PUnavailableError):
        ttok.get_tokenizer("espeak", lang="de").texts_to_tokens(["hallo"])


def _unigram_pieces(spm):
    return [("<unk>", 0.0, spm.UNKNOWN), ("<s>", 0.0, spm.CONTROL),
            ("</s>", 0.0, spm.CONTROL), ("<pad>", 0.0, spm.CONTROL),
            ("▁", -3.0, spm.NORMAL), ("▁HELLO", -1.0, spm.NORMAL),
            ("▁WORLD", -1.2, spm.NORMAL), ("▁HELL", -2.5, spm.NORMAL),
            ("O", -2.0, spm.NORMAL), ("W", -2.0, spm.NORMAL), ("OR", -2.2, spm.NORMAL),
            ("LD", -2.4, spm.NORMAL), ("H", -4.0, spm.NORMAL), ("E", -4.0, spm.NORMAL),
            ("L", -4.0, spm.NORMAL), ("D", -4.0, spm.NORMAL), ("R", -4.0, spm.NORMAL)]


def _bpe_pieces(spm):
    return [("<unk>", 0.0, spm.UNKNOWN), ("▁", -1.0, spm.NORMAL), ("A", -1.0, spm.NORMAL),
            ("B", -1.0, spm.NORMAL), ("C", -1.0, spm.NORMAL), ("AB", -2.0, spm.NORMAL),
            ("BC", -3.0, spm.NORMAL), ("▁AB", -4.0, spm.NORMAL),
            ("▁ABC", -9.0, spm.NORMAL)]


def _byte_pieces(spm):
    return [("<unk>", 0.0, spm.UNKNOWN), ("▁", -1.0, spm.NORMAL), ("A", -1.0, spm.NORMAL)] \
        + [(f"<0x{b:02X}>", 0.0, spm.BYTE) for b in range(256)]


@pytest.mark.parametrize("kind,texts", [
    ("unigram", ["HELLO WORLD", "HELLO", "WORLD HELLO HELLO", "HELD OR", "HELLO Z"]),
    ("bpe", ["ABC", "AB C", "CAB BCA"]),
    ("byte", ["Aé", "A A", "ü"]),
])
def test_spm_equals_jax(kind, texts):
    """The same tiny models JAX's tests build, serialized by each package,
    read back by each: equal bytes, pieces and ids."""
    def model(spm):
        if kind == "unigram":
            return spm.build_model_proto(_unigram_pieces(spm), model_type=spm.UNIGRAM)
        if kind == "bpe":
            return spm.build_model_proto(_bpe_pieces(spm), model_type=spm.BPE)
        return spm.build_model_proto(_byte_pieces(spm), model_type=spm.UNIGRAM,
                                     byte_fallback=True)

    raw = model(tspm)
    assert raw == model(jspm)
    port = tspm.SentencePieceEncoder(model_proto=raw)
    ref = jspm.SentencePieceEncoder(model_proto=raw)
    assert port.get_piece_size() == ref.get_piece_size()
    for text in texts:
        assert port.encode(text, out_type=str) == ref.encode(text, out_type=str), text
        ids = port.encode(text)
        assert ids == ref.encode(text) and port.decode(ids) == ref.decode(ids)
    if kind == "unigram":
        assert port.encode("HELLO WORLD", out_type=str) == ["▁HELLO", "▁WORLD"]
    elif kind == "bpe":
        assert port.encode("ABC", out_type=str) == ["▁ABC"]
    else:
        assert port.encode("Aé", out_type=str)[2:] == ["<0xC3>", "<0xA9>"]


def test_libritts_equals_jax(offline_g2p, tmp_path, token_file):
    bpe = tmp_path / "bpe.model"
    bpe.write_bytes(tspm.build_model_proto(_unigram_pieces(tspm), model_type=tspm.UNIGRAM))
    port = ttok.LibriTTSTokenizer(str(bpe), token_type="bpe")
    ref = jtok.LibriTTSTokenizer(str(bpe), token_type="bpe")
    assert (port.vocab_size, port.pad_id) == (ref.vocab_size, ref.pad_id) == (17, 3)
    assert port.texts_to_token_ids(["hello world"]) == [[5, 6]] == \
        ref.texts_to_token_ids(["hello world"])
    texts = ['Smith & Co. (draft) - "v2"; see Mr. Jones', "mr jones", "café 42 times"]
    for token_type, tf in (("char", None), ("phone", token_file)):
        port = ttok.get_tokenizer("libritts", tf, token_type=token_type)
        ref = jtok.get_tokenizer("libritts", tf, token_type=token_type)
        for t in texts:
            assert port.normalize(t) == ref.normalize(t)
        assert port.texts_to_tokens(texts) == ref.texts_to_tokens(texts)
        if tf is not None:
            assert port.texts_to_token_ids(texts) == ref.texts_to_token_ids(texts)
    assert port.normalize(texts[0]) == "SMITH AND COMPANY DRAFT V TWO, SEE MISTER JONES"


def test_chinese_offline_pinyin_equals_jax(token_file):
    """hanzi -> tone3 through jieba and the offline reading table (pypinyin
    absent), sandhi included; ids through the tokens file."""
    pytest.importorskip("jieba")
    if "pypinyin" in sys.modules or _importable("pypinyin"):
        pytest.skip("pypinyin is installed: the offline table is not used")
    for text in ("你好世界", "不是", "一个", "一百", "东西", "孩子", "电子", "银行", "重新",
                 "我们在中国说中文"):
        assert ttok.hanzi_to_pinyin(text) == jtok.hanzi_to_pinyin(text), text
    assert ttok.hanzi_to_pinyin("你好世界") == ["ni2", "hao3", "shi4", "jie4"]
    tok = ttok.get_tokenizer("emilia", token_file)
    ids = tok.texts_to_token_ids(["你好世界。"])[0]
    assert ids == jtok.get_tokenizer("emilia", token_file).texts_to_token_ids(["你好世界。"])[0]
    expect = ["n0", "i2", "h0", "ao3", "sh0", "i4", "j0", "ie4", "."]
    assert ids == [tok.token2id[t] for t in expect]


def _importable(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def test_get_tokenizer_names():
    for name in ("emilia", "espeak", "dialog", "libritts", "simple"):
        assert type(ttok.get_tokenizer(name)).__name__ == \
            type(jtok.get_tokenizer(name)).__name__
    with pytest.raises(ValueError, match="Unsupported tokenizer"):
        ttok.get_tokenizer("nope")
