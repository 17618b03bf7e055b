"""Minimal pure-Python TensorBoard event writer (scalars only).

The trainer mirrors its train_log.jsonl scalars into TensorBoard event
files under the exp dir.  TensorBoard's on-disk format is a TFRecord
stream of serialized Event protos; both are simple enough to hand-encode
(varint/wire-format protobuf + masked-CRC32C framing), so no
tensorflow/tensorboard dependency is needed to WRITE the files — only to
view them.

Format notes:
  * TFRecord framing: u64le(len) crc32c(len-bytes) data crc32c(data), where
    both CRCs are "masked": ((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff.
  * Event proto fields used: 1 wall_time (double), 2 step (int64),
    3 file_version (string, first record only), 5 summary.
  * Summary: repeated field 1 = Value{1: tag (string), 2: simple_value
    (float)}.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; zlib.crc32 is CRC32/IEEE — wrong poly.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format encoding (just what Event/Summary need).
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_bytes(num: int, value: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           scalars: Optional[Dict[str, float]] = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(
                1,
                _field_bytes(1, tag.encode()) + _field_float(2, float(v)),
            )
            for tag, v in scalars.items()
        )
        msg += _field_bytes(5, summary)
    return msg


def _tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


class TBWriter:
    """Append-only scalar event writer, TensorBoard-compatible.

    Usage::

        tb = TBWriter(exp_dir / "tensorboard")
        tb.add_scalars(step, {"train/loss": 0.3, "train/lr": 1e-3})
    """

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        name = "events.out.tfevents.%010d.%s.%d" % (
            int(time.time()), socket.gethostname(), os.getpid()
        )
        self.path = self.logdir / name
        with open(self.path, "wb") as f:
            f.write(_tfrecord(_event(time.time(), file_version="brain.Event:2")))

    def add_scalars(self, step: int, scalars: Dict[str, float]):
        rec = _tfrecord(_event(time.time(), step=step, scalars=scalars))
        with open(self.path, "ab") as f:
            f.write(rec)

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars(step, {tag: value})


# ---------------------------------------------------------------------------
# Reader (for tests / offline verification without tensorboard installed).
# ---------------------------------------------------------------------------


def read_events(path):
    """Parse a TB event file back into [(wall_time, step, {tag: value})].
    Verifies both framing CRCs of every record."""
    out = []
    blob = Path(path).read_bytes()
    off = 0
    while off < len(blob):
        (length,) = struct.unpack_from("<Q", blob, off)
        header = blob[off:off + 8]
        (hcrc,) = struct.unpack_from("<I", blob, off + 8)
        assert hcrc == _masked_crc(header), "header CRC mismatch"
        data = blob[off + 12:off + 12 + length]
        (dcrc,) = struct.unpack_from("<I", blob, off + 12 + length)
        assert dcrc == _masked_crc(data), "data CRC mismatch"
        off += 16 + length
        out.append(_parse_event(data))
    return out


def _read_varint(data: bytes, off: int):
    shift, val = 0, 0
    while True:
        b = data[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7


def _parse_fields(data: bytes):
    off = 0
    while off < len(data):
        key, off = _read_varint(data, off)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, off = _read_varint(data, off)
        elif wt == 1:
            val = data[off:off + 8]
            off += 8
        elif wt == 5:
            val = data[off:off + 4]
            off += 4
        elif wt == 2:
            ln, off = _read_varint(data, off)
            val = data[off:off + ln]
            off += ln
        else:  # pragma: no cover
            raise ValueError(f"wire type {wt}")
        yield num, wt, val


def _parse_event(data: bytes):
    wall, step, scalars = 0.0, 0, {}
    for num, wt, val in _parse_fields(data):
        if num == 1 and wt == 1:
            wall = struct.unpack("<d", val)[0]
        elif num == 2 and wt == 0:
            step = val
        elif num == 5 and wt == 2:
            for n2, _w2, v2 in _parse_fields(val):
                if n2 != 1:
                    continue
                tag, fv = None, None
                for n3, w3, v3 in _parse_fields(v2):
                    if n3 == 1 and w3 == 2:
                        tag = v3.decode()
                    elif n3 == 2 and w3 == 5:
                        fv = struct.unpack("<f", v3)[0]
                if tag is not None and fv is not None:
                    scalars[tag] = fv
    return wall, step, scalars
