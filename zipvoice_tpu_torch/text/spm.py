"""Pure-Python SentencePiece model reader + encoder.

The reference's ``LibriTTSTokenizer(token_type="bpe")`` requires the
``sentencepiece`` C++ package (ref zipvoice/tokenizer/tokenizer.py:543-546);
where it is not installed, this self-contained reader handles
for the published ``.model`` files (protobuf ``ModelProto``) and both
segmentation algorithms sentencepiece ships:

* **unigram** (the default `model_type`, used by the icefall LibriTTS
  models): Viterbi search maximizing the sum of piece log-probs;
* **bpe**: greedy merge of the adjacent pair whose concatenation is the
  best-scoring piece in the vocab (piece scores encode merge rank).

Covered model features: whitespace escape (U+2581), ``add_dummy_prefix``,
``remove_extra_whitespaces``, user-defined symbols (always preferred,
matching spm's `is_unused`/user-defined override), byte fallback
(``<0xNN>`` pieces), unk penalty.  NOT covered: the precompiled NFKC
charsmap (normalization beyond whitespace handling) — TTS frontends
normalize text upstream (tacotron cleaners), so inputs are already ASCII-ish;
a golden cross-check against the real ``sentencepiece`` runs when that
package is importable (tests/test_text.py, tests/test_torch_text.py).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

WS = "▁"  # sentencepiece whitespace escape

# piece types (sentencepiece_model.proto: SentencePiece.Type)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

# trainer_spec.model_type
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4


# ---------------------------------------------------------------------------
# minimal protobuf wire-format reader (only what ModelProto needs)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) for one message's bytes."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:  # 64-bit
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:  # 32-bit
            val = buf[i:i + 4]
            i += 4
        else:  # groups (3/4) never appear in ModelProto
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


class SpmModel:
    """Parsed ModelProto: pieces, scores, types + the spec fields we use."""

    def __init__(self, data: bytes):
        self.pieces: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        # defaults from sentencepiece_model.proto
        self.model_type = UNIGRAM
        self.unk_id, self.bos_id, self.eos_id, self.pad_id = 0, 1, 2, -1
        self.byte_fallback = False
        self.add_dummy_prefix = True
        self.remove_extra_whitespaces = True
        self.escape_whitespaces = True

        for field, _wire, val in _fields(data):
            if field == 1:  # repeated SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in _fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                self.pieces.append(piece)
                self.scores.append(score)
                self.types.append(ptype)
            elif field == 2:  # TrainerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3:
                        self.model_type = v2
                    elif f2 == 35:
                        self.byte_fallback = bool(v2)
                    elif f2 == 40:
                        self.unk_id = _zigzag_free_int32(v2)
                    elif f2 == 41:
                        self.bos_id = _zigzag_free_int32(v2)
                    elif f2 == 42:
                        self.eos_id = _zigzag_free_int32(v2)
                    elif f2 == 43:
                        self.pad_id = _zigzag_free_int32(v2)
            elif field == 3:  # NormalizerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3:
                        self.add_dummy_prefix = bool(v2)
                    elif f2 == 4:
                        self.remove_extra_whitespaces = bool(v2)
                    elif f2 == 5:
                        self.escape_whitespaces = bool(v2)


def _zigzag_free_int32(v: int) -> int:
    """proto int32 stored as two's-complement varint (e.g. pad_id = -1)."""
    return v - (1 << 64) if v >= (1 << 63) else (v - (1 << 32) if v >= (1 << 31) else v)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

class SentencePieceEncoder:
    """API-compatible subset of ``sentencepiece.SentencePieceProcessor``."""

    def __init__(self, model_file: Optional[str] = None,
                 model_proto: Optional[bytes] = None):
        if model_proto is None:
            with open(model_file, "rb") as f:
                model_proto = f.read()
        m = SpmModel(model_proto)
        self.m = m
        self.piece2id: Dict[str, int] = {p: i for i, p in enumerate(m.pieces)}
        self._max_piece_len = max((len(p) for p in m.pieces), default=1)
        # spm's unk penalty: min piece score - 10
        real = [s for s, t in zip(m.scores, m.types) if t == NORMAL]
        self._unk_score = (min(real) if real else 0.0) - 10.0
        self._byte_ids = {}
        if m.byte_fallback:
            for i, (p, t) in enumerate(zip(m.pieces, m.types)):
                if t == BYTE:
                    self._byte_ids[int(p[1:-1], 16)] = i

    # -- sentencepiece API surface ------------------------------------------
    def load(self, model_file: str):  # matches spm call pattern
        self.__init__(model_file)

    def get_piece_size(self) -> int:
        return len(self.m.pieces)

    vocab_size = get_piece_size

    def piece_to_id(self, piece: str) -> int:
        return self.piece2id.get(piece, self.m.unk_id)

    def id_to_piece(self, idx: int) -> str:
        return self.m.pieces[idx]

    def encode(self, text, out_type=int):
        if isinstance(text, (list, tuple)):
            return [self.encode(t, out_type) for t in text]
        pieces = self._encode_pieces(self._normalize(text))
        if out_type is str:
            return pieces
        return [self.piece_to_id(p) for p in pieces]

    def decode(self, ids) -> str:
        if ids and isinstance(ids[0], (list, tuple)):
            return [self.decode(x) for x in ids]
        out: List[str] = []
        byte_acc: List[int] = []
        for i in ids:
            p = self.m.pieces[i]
            t = self.m.types[i]
            if t == BYTE:
                byte_acc.append(int(p[1:-1], 16))
                continue
            if byte_acc:
                out.append(bytes(byte_acc).decode("utf-8", errors="replace"))
                byte_acc = []
            if t in (CONTROL, UNKNOWN):
                continue
            out.append(p)
        if byte_acc:
            out.append(bytes(byte_acc).decode("utf-8", errors="replace"))
        text = "".join(out).replace(WS, " ")
        return text[1:] if text.startswith(" ") else text

    # -- internals -----------------------------------------------------------
    def _normalize(self, text: str) -> str:
        if self.m.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self.m.add_dummy_prefix:
            text = " " + text
        if self.m.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    def _usable(self, piece: str) -> bool:
        i = self.piece2id.get(piece)
        if i is None:
            return False
        return self.m.types[i] in (NORMAL, USER_DEFINED)

    def _encode_pieces(self, s: str) -> List[str]:
        if not s:
            return []
        if self.m.model_type == BPE:
            segs = self._bpe(s)
        else:
            segs = self._viterbi(s)
        out: List[str] = []
        for seg in segs:
            if self._usable(seg):
                out.append(seg)
            elif self._byte_ids:
                out.extend(f"<0x{b:02X}>" for b in seg.encode("utf-8"))
            else:
                out.append(self.m.pieces[self.m.unk_id])
        return out

    def _viterbi(self, s: str) -> List[str]:
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Tuple[int, str]] = [(0, "")] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self._max_piece_len)
            matched = False
            for j in range(i + 1, hi + 1):
                piece = s[i:j]
                idx = self.piece2id.get(piece)
                if idx is None or self.m.types[idx] not in (NORMAL, USER_DEFINED):
                    continue
                # user-defined symbols get a large bonus so they always win
                # (spm scores them length*max+1 at runtime)
                sc = (len(piece) * 10.0 + 1e6
                      if self.m.types[idx] == USER_DEFINED
                      else self.m.scores[idx])
                matched = True
                if best[i] + sc > best[j]:
                    best[j] = best[i] + sc
                    back[j] = (i, piece)
            # unk: single char fallback so the lattice always completes
            j = i + 1
            if not matched or best[i] + self._unk_score > best[j]:
                if best[i] + self._unk_score > best[j]:
                    best[j] = best[i] + self._unk_score
                    back[j] = (i, s[i:j])
        out: List[str] = []
        j = n
        while j > 0:
            i, piece = back[j]
            out.append(piece)
            j = i
        return out[::-1]

    def _bpe(self, s: str) -> List[str]:
        symbols = list(s)
        if len(symbols) < 2:
            return symbols
        while True:
            best_score, best_idx = None, -1
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                idx = self.piece2id.get(merged)
                if idx is None or self.m.types[idx] not in (NORMAL, USER_DEFINED):
                    continue
                sc = self.m.scores[idx]
                if best_score is None or sc > best_score:
                    best_score, best_idx = sc, i
            if best_idx < 0:
                return symbols
            symbols[best_idx:best_idx + 2] = [symbols[best_idx] + symbols[best_idx + 1]]
            if len(symbols) < 2:
                return symbols


# ---------------------------------------------------------------------------
# writer (tests + make_tokens tooling): build a ModelProto from a vocab
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def build_model_proto(
    pieces: List[Tuple[str, float, int]],
    model_type: int = UNIGRAM,
    unk_id: int = 0,
    byte_fallback: bool = False,
    add_dummy_prefix: bool = True,
) -> bytes:
    """Serialize a minimal valid ModelProto (used by tests and by
    bin/make_tokens to ship dependency-free BPE vocabularies)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += _field(1, 2, _varint(len(pb)) + pb)
        body += _field(2, 5, struct.pack("<f", score))
        body += _field(3, 0, _varint(ptype))
        out += _field(1, 2, _varint(len(body)) + bytes(body))
    ts = bytearray()
    ts += _field(3, 0, _varint(model_type))
    ts += _field(35, 0, _varint(1 if byte_fallback else 0))
    ts += _field(40, 0, _varint(unk_id))
    out += _field(2, 2, _varint(len(ts)) + bytes(ts))
    ns = bytearray()
    ns += _field(3, 0, _varint(1 if add_dummy_prefix else 0))
    ns += _field(4, 0, _varint(1))
    ns += _field(5, 0, _varint(1))
    out += _field(3, 2, _varint(len(ns)) + bytes(ns))
    return bytes(out)
