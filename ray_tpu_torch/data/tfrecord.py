"""Self-contained TFRecord + tf.train.Example codec (a copy of
`ray_tpu/data/tfrecord.py`).

Analogue of the reference's tfrecords datasource (ref: python/ray/data/
datasource/tfrecords_datasource.py — which imports tensorflow/crc32c).
This image is zero-egress and has no tensorflow, so the wire formats are
implemented directly:

  TFRecord framing: u64le length | u32le masked-crc32c(length) |
                    payload | u32le masked-crc32c(payload)
  tf.train.Example: a protobuf with
      Example{ features:1 } / Features{ map<string,Feature> feature:1 }
      Feature{ bytes_list:1 | float_list:2 | int64_list:3 }
      BytesList{ repeated bytes value:1 }
      FloatList{ repeated float value:1 (packed) }
      Int64List{ repeated int64 value:1 (packed) }

Only the wire-format subset Example needs is implemented (varints,
length-delimited fields, fixed32 floats).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) — table-driven; the masking is the TFRecord scheme
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def read_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if len(head) < 12:
                return
            (length,), (lcrc,) = (struct.unpack("<Q", head[:8]),
                                  struct.unpack("<I", head[8:]))
            if _masked_crc(head[:8]) != lcrc:
                raise ValueError(f"corrupt tfrecord length crc in {path}")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if _masked_crc(payload) != pcrc:
                raise ValueError(f"corrupt tfrecord data crc in {path}")
            yield payload


def write_records(path: str, payloads: Iterator[bytes]) -> int:
    n = 0
    with open(path, "wb") as f:
        for p in payloads:
            head = struct.pack("<Q", len(p))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(p)
            f.write(struct.pack("<I", _masked_crc(p)))
            n += 1
    return n


# ---------------------------------------------------------------------------
# minimal protobuf wire helpers
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _iter_fields(buf: bytes) -> Iterator[tuple]:
    """Yield (field_number, wire_type, value, value_end)."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


# ---------------------------------------------------------------------------
# tf.train.Example encode/decode
# ---------------------------------------------------------------------------

def encode_example(row: Dict[str, Any]) -> bytes:
    """Dict -> serialized Example. bytes/str -> BytesList, float ->
    FloatList, int/bool -> Int64List; lists/arrays of those likewise."""
    import numpy as np

    entries = b""
    for key, value in row.items():
        if isinstance(value, np.ndarray):
            value = value.tolist()
        if not isinstance(value, (list, tuple)):
            value = [value]
        if not value:
            feature = _ld(3, b"")
        elif isinstance(value[0], (bytes, str)):
            items = b"".join(
                _ld(1, v.encode() if isinstance(v, str) else v)
                for v in value)
            feature = _ld(1, items)
        elif isinstance(value[0], (bool, int, np.integer)):
            packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                              for v in value)
            feature = _ld(3, _ld(1, packed))
        elif isinstance(value[0], float) or hasattr(value[0], "__float__"):
            packed = b"".join(struct.pack("<f", float(v)) for v in value)
            feature = _ld(2, _ld(1, packed))
        else:
            raise TypeError(f"unsupported feature type for {key!r}: "
                            f"{type(value[0]).__name__}")
        entry = _ld(1, key.encode()) + _ld(2, feature)
        entries += _ld(1, entry)
    features = entries
    return _ld(1, features)


def decode_example(payload: bytes) -> Dict[str, Any]:
    row: Dict[str, Any] = {}
    for field, _, features in _iter_fields(payload):
        if field != 1:
            continue
        for f2, _, entry in _iter_fields(features):
            if f2 != 1:
                continue
            key = None
            feature = b""
            for f3, _, v in _iter_fields(entry):
                if f3 == 1:
                    key = v.decode()
                elif f3 == 2:
                    feature = v
            if key is None:
                continue
            row[key] = _decode_feature(feature)
    return row


def _signed64(val: int) -> int:
    return val - (1 << 64) if val >= 1 << 63 else val


def _decode_feature(feature: bytes) -> Any:
    """Both packed and unpacked repeated encodings are accepted (packed
    is merely the default on the wire; conformant parsers must read
    either), accumulating every occurrence."""
    for field, _, body in _iter_fields(feature):
        if field == 1:      # BytesList
            values = [v for f, _, v in _iter_fields(body) if f == 1]
            return values[0] if len(values) == 1 else values
        if field == 2:      # FloatList
            floats: list = []
            for f, wire, v in _iter_fields(body):
                if f != 1:
                    continue
                if wire == 2:       # packed run
                    floats.extend(struct.unpack_from("<f", v, i)[0]
                                  for i in range(0, len(v), 4))
                elif wire == 5:     # unpacked element
                    floats.append(struct.unpack("<f", v)[0])
            return floats[0] if len(floats) == 1 else floats
        if field == 3:      # Int64List
            ints: list = []
            for f, wire, v in _iter_fields(body):
                if f != 1:
                    continue
                if wire == 2:       # packed run
                    pos = 0
                    while pos < len(v):
                        val, pos = _read_varint(v, pos)
                        ints.append(_signed64(val))
                elif wire == 0:     # unpacked element
                    ints.append(_signed64(v))
            return ints[0] if len(ints) == 1 else ints
    return None
