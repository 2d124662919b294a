"""Typed wire codec + protocol versioning for the control plane.

The port's copy of `ray_tpu/core/distributed/wire.py`,
importing `ray_tpu_torch` only.

The reference isolates every process boundary behind proto3 schemas
(ref: src/ray/protobuf/core_worker.proto:425 and 23 sibling files), so
version skew or a non-Python peer fails with a typed error instead of a
deserialize crash. Our equivalent, sized to the actual cross-language
surface (KV, task submit, worker handshake, actor calls):

* a PROTOCOL VERSION byte rides in every RPC frame header (rpc.py);
  a mismatched peer gets a clear "protocol version mismatch" error,
  never a garbled unpickle;
* every payload is prefixed with a CODEC byte: pickle (0) remains the
  Python<->Python codec — arbitrary objects, exceptions with state —
  while the TYPED codec (1) is a self-describing binary schema over
  the cross-language data model (None/bool/int64/float64/bytes/str/
  list/dict), hand-decodable from C++ in ~100 lines with no pickle
  opcode machine. The C++ headers (cpp/include/ray_tpu_client/,
  ray_tpu_worker/) implement exactly this codec.

Typed format, little-endian throughout (x86/arm64):

    value := 0x00                      # None
           | 0x01 | 0x02               # True / False
           | 0x03 i64                  # int
           | 0x04 f64                  # float
           | 0x05 u32 raw              # bytes
           | 0x06 u32 utf8             # str
           | 0x07 u32 value*           # list (tuples encode as list)
           | 0x08 u32 (value value)*   # dict
           | 0x09                      # out-of-band raw body (RAW codec)

RAW codec (2): the bulk-data frame format. A message whose structure
contains exactly one `Raw(buffer)` marker is encoded as

    payload := 0x02 | u32 hlen | typed(header) | body

where the header is the typed encoding of the message with the marker
replaced by tag 0x09, and the body bytes follow verbatim — no pickle,
no length-prefix copies. The encoder returns (header, body) as SEPARATE
buffers so the transport can writev them (header built once, the body
handed to the socket as the caller's memoryview); the decoder splices a
zero-copy memoryview of the body back into the 0x09 position. This is
the seam object-chunk transfers ride: a 5 MiB chunk crosses the RPC
layer without ever being copied into a pickle stream on either side
(ref: the reference moves chunk payloads as raw grpc bytes fields,
object_manager.proto Push).
"""
from __future__ import annotations

import struct
from typing import Any, Optional, Tuple

# Deliberately outside 1..6: the previous (unversioned) frame format
# carried the frame-TYPE byte at this offset, so any version equal to a
# frame type (REQ=1..CANCEL=6) would make an old-generation peer pass
# the version check and be misparsed instead of cleanly rejected.
# v17: RAW codec (out-of-band binary attachment frames).
PROTOCOL_VERSION = 17

CODEC_PICKLE = 0
CODEC_TYPED = 1
CODEC_RAW = 2

_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_U32 = struct.Struct("<I")

_T_NONE = 0x00
_T_TRUE = 0x01
_T_FALSE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_BYTES = 0x05
_T_STR = 0x06
_T_LIST = 0x07
_T_DICT = 0x08
_T_RAW = 0x09


class WireError(ValueError):
    """A value outside the typed model, or a corrupt typed payload."""


class Raw:
    """Marks one buffer in an RPC message for out-of-band raw-frame
    transport. The wrapped buffer never enters a codec stream: the send
    path writes it to the socket directly (after the typed header) and
    the receive path splices a zero-copy memoryview back in its place.

    Deliberately unpicklable: a Raw that escapes the raw-frame scan
    (nested deeper than the bounded scan looks) must fail loudly at
    encode time, not arrive at the peer as an opaque object.
    """

    __slots__ = ("buffer",)

    def __init__(self, buffer):
        self.buffer = buffer

    def __len__(self) -> int:
        return len(self.buffer)

    def __reduce__(self):
        raise WireError(
            "Raw buffer outside a raw-frame position (nest it at the "
            "top levels of the RPC message, see wire.scan_raw)")


def _enc(obj: Any, out: bytearray,
         raw_cell: Optional[list] = None) -> None:
    if obj is None:
        out.append(_T_NONE)
    elif obj is True:
        out.append(_T_TRUE)
    elif obj is False:
        out.append(_T_FALSE)
    elif isinstance(obj, int):
        out.append(_T_INT)
        try:
            out += _I64.pack(obj)
        except struct.error:
            raise WireError(f"int {obj} exceeds int64") from None
    elif isinstance(obj, float):
        out.append(_T_FLOAT)
        out += _F64.pack(obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_T_BYTES)
        out += _U32.pack(len(b))
        out += b
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(_T_STR)
        out += _U32.pack(len(b))
        out += b
    elif isinstance(obj, (list, tuple)):
        out.append(_T_LIST)
        out += _U32.pack(len(obj))
        for item in obj:
            _enc(item, out, raw_cell)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        out += _U32.pack(len(obj))
        for k, v in obj.items():
            _enc(k, out, raw_cell)
            _enc(v, out, raw_cell)
    elif isinstance(obj, Raw):
        if raw_cell is None:
            raise WireError("Raw buffer is only valid under the RAW codec")
        if raw_cell:
            raise WireError("at most one Raw buffer per RPC message")
        raw_cell.append(obj.buffer)
        out.append(_T_RAW)
    else:
        raise WireError(
            f"{type(obj).__name__} is outside the typed wire model "
            f"(None/bool/int/float/bytes/str/list/dict)")


def typed_dumps(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def raw_dumps(obj: Any) -> Tuple[bytes, Any]:
    """Encode a message containing exactly one Raw marker. Returns
    (header_bytes, body_buffer): the header is `u32 hlen | typed` with
    tag 0x09 at the marker position; the body is the caller's buffer,
    untouched, to be writev'd after the header."""
    out = bytearray()
    cell: list = []
    _enc(obj, out, cell)
    if not cell:
        raise WireError("raw_dumps: message contains no Raw buffer")
    return _U32.pack(len(out)) + bytes(out), cell[0]


def scan_raw(obj: Any, depth: int = 3) -> Optional[Raw]:
    """Bounded search for a Raw marker at the top levels of an RPC
    message (kwargs dicts, reply dicts, small lists). Bounded so the
    control-plane hot path never pays a deep traversal; Raw markers
    nested past the bound fail loudly via Raw.__reduce__."""
    if isinstance(obj, Raw):
        return obj
    if depth <= 0:
        return None
    if isinstance(obj, dict):
        for v in obj.values():
            r = scan_raw(v, depth - 1)
            if r is not None:
                return r
    elif isinstance(obj, (list, tuple)):
        for v in obj[:32]:
            r = scan_raw(v, depth - 1)
            if r is not None:
                return r
    return None


def _dec(data: memoryview, pos: int,
         raw_body: Optional[memoryview] = None) -> Tuple[Any, int]:
    try:
        tag = data[pos]
    except IndexError:
        raise WireError("truncated typed payload") from None
    pos += 1
    try:
        if tag == _T_NONE:
            return None, pos
        if tag == _T_TRUE:
            return True, pos
        if tag == _T_FALSE:
            return False, pos
        if tag == _T_INT:
            return _I64.unpack_from(data, pos)[0], pos + 8
        if tag == _T_FLOAT:
            return _F64.unpack_from(data, pos)[0], pos + 8
        if tag in (_T_BYTES, _T_STR):
            (n,) = _U32.unpack_from(data, pos)
            pos += 4
            if pos + n > len(data):
                raise WireError("truncated typed payload")
            raw = bytes(data[pos:pos + n])
            return (raw if tag == _T_BYTES
                    else raw.decode("utf-8")), pos + n
        if tag == _T_LIST:
            (n,) = _U32.unpack_from(data, pos)
            pos += 4
            items = []
            for _ in range(n):
                item, pos = _dec(data, pos, raw_body)
                items.append(item)
            return items, pos
        if tag == _T_DICT:
            (n,) = _U32.unpack_from(data, pos)
            pos += 4
            d = {}
            for _ in range(n):
                k, pos = _dec(data, pos, raw_body)
                v, pos = _dec(data, pos, raw_body)
                d[k] = v
            return d, pos
        if tag == _T_RAW:
            if raw_body is None:
                raise WireError("0x09 raw tag outside a RAW-codec frame")
            return raw_body, pos
    except struct.error:
        raise WireError("truncated typed payload") from None
    raise WireError(f"unknown typed tag 0x{tag:02x}")


def typed_loads(data) -> Any:
    """Accepts bytes or memoryview (zero-copy slicing off codec bytes)."""
    view = memoryview(data)
    obj, pos = _dec(view, 0)
    if pos != len(view):
        raise WireError(
            f"{len(view) - pos} trailing bytes after typed value")
    return obj


# Placeholder the 0x09 tag decodes to when the body is NOT in hand —
# raw_header_loads callers (recv_into receivers) read the header first,
# then stream the body straight into its destination buffer.
RAW_BODY = type("RawBodyPlaceholder", (), {
    "__repr__": lambda self: "<raw body>"})()


def raw_header_loads(header) -> Any:
    """Decode just the typed header of a RAW frame (no hlen prefix, no
    body): the 0x09 position decodes to the RAW_BODY sentinel. Used by
    direct-to-shm receivers that want the metadata BEFORE reading the
    body, so the body bytes can be received straight into the store
    mmap instead of through an intermediate buffer."""
    view = memoryview(header)
    obj, pos = _dec(view, 0, raw_body=RAW_BODY)
    if pos != len(view):
        raise WireError(
            f"{len(view) - pos} trailing bytes after raw header")
    return obj


def raw_loads(data) -> Any:
    """Decode a RAW-codec payload (after the codec byte): `u32 hlen |
    typed(header) | body`. The body is spliced into the 0x09 position
    as a zero-copy memoryview of `data` — the caller's frame bytes stay
    alive as long as the decoded message references them."""
    view = memoryview(data)
    if len(view) < 4:
        raise WireError("truncated raw frame")
    (hlen,) = _U32.unpack_from(view, 0)
    if 4 + hlen > len(view):
        raise WireError("truncated raw frame header")
    header = view[4:4 + hlen]
    body = view[4 + hlen:]
    obj, pos = _dec(header, 0, raw_body=body)
    if pos != hlen:
        raise WireError(
            f"{hlen - pos} trailing bytes after raw frame header")
    return obj


def typed_safe(obj: Any) -> Any:
    """Project an RPC reply onto the typed model: exceptions become
    'Type: message' strings (a non-Python peer cannot rehydrate them
    anyway — the same rule the reference's cross-language boundary
    applies), other foreign objects become their repr."""
    if obj is None or isinstance(obj, (bool, int, float, bytes, str)):
        return obj
    if isinstance(obj, (list, tuple)):
        return [typed_safe(x) for x in obj]
    if isinstance(obj, dict):
        return {typed_safe(k): typed_safe(v) for k, v in obj.items()}
    if isinstance(obj, BaseException):
        return f"{type(obj).__name__}: {obj}"
    return repr(obj)
