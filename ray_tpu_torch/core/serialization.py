"""Object serialization: pickle + out-of-band zero-copy buffers, counterpart
of `ray_tpu/core/serialization.py`.

Analogue of the reference's SerializationContext
(ref: python/ray/_private/serialization.py): pickle protocol 5 with
out-of-band buffers so large numpy payloads are written into the store
without an extra copy, and read back zero-copy.

`torch.Tensor` pickles its storage in-band through `torch.save`; here a
dense tensor travels as one out-of-band buffer of its bytes instead, with
its dtype, shape, device and requires_grad. A CUDA tensor goes through a
host copy and comes back on its saved device, as a `jax.Array` comes back
as an array: there is no device-resident store. A non-leaf tensor that
requires grad is refused, as torch's own pickling refuses it. torch is
imported only where a tensor is met: a process that has not imported it
(the control plane) holds no tensor, and pickles with the plain picklers.

Wire format (the same bytes as the JAX package's):

    magic   u32   "RTPU"
    version u8
    flags   u8    bit0 = payload is a serialized exception
    nbufs   u16
    pkl_len u64
    buf_len u64 * nbufs
    <pickle bytes>
    <64-byte-aligned buffer 0> ...
"""
from __future__ import annotations

import copyreg
import io
import pickle
import struct
import sys
import warnings
from typing import Any, List, Tuple

import cloudpickle

MAGIC = 0x52545055
_HEADER = struct.Struct("<IBBHQ")
ALIGN = 64

FLAG_ERROR = 1


def _align(n: int) -> int:
    return (n + ALIGN - 1) & ~(ALIGN - 1)


def _rebuild_tensor(buf, dtype, shape: tuple, device, requires_grad: bool):
    import torch

    view = memoryview(buf).cast("B")
    out = torch.empty(view.nbytes, dtype=torch.uint8, device=device)
    if view.nbytes:
        with warnings.catch_warnings():
            # The store's bytes are read-only; they are only read here, into
            # the new tensor.
            warnings.simplefilter("ignore", UserWarning)
            out.copy_(torch.frombuffer(view, dtype=torch.uint8))
    return out.view(dtype).reshape(shape).requires_grad_(requires_grad)


def _reduce_tensor(t):
    import torch

    if t.layout != torch.strided or t.is_quantized or t.device.type == "meta":
        return t.__reduce_ex__(5)
    if t.requires_grad and not t.is_leaf:
        raise RuntimeError(
            "Cowardly refusing to serialize non-leaf tensor which requires_grad, "
            "since autograd does not support crossing process boundaries.")
    host = t.detach().cpu().contiguous()   # a host copy for a CUDA tensor
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor, (pickle.PickleBuffer(raw), t.dtype, tuple(t.shape),
                              t.device, t.requires_grad))


_TENSOR_PICKLERS = None


def _picklers() -> tuple:
    """(pickler, cloudpickler) classes: with the tensor reducer once torch
    is imported in this process, else the plain ones."""
    global _TENSOR_PICKLERS
    if _TENSOR_PICKLERS is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return pickle.Pickler, cloudpickle.CloudPickler

        class _TensorPickler(pickle.Pickler):
            dispatch_table = {**copyreg.dispatch_table,
                              torch.Tensor: _reduce_tensor}

        class _TensorCloudPickler(cloudpickle.CloudPickler):
            dispatch_table = {**cloudpickle.CloudPickler.dispatch_table,
                              torch.Tensor: _reduce_tensor}

        _TENSOR_PICKLERS = (_TensorPickler, _TensorCloudPickler)
    return _TENSOR_PICKLERS


def serialize(obj: Any, *, is_error: bool = False) -> Tuple[bytes, List[memoryview]]:
    """Serialize to (header+pickle bytes, out-of-band buffers)."""
    buffers: List[pickle.PickleBuffer] = []
    plain, cloud = _picklers()
    try:
        # Plain pickle first: the C pickler is ~10x cloudpickle and
        # handles the common case (task args/results are data, not
        # code). Two fallbacks to cloudpickle: objects plain pickle
        # can't do at all (closures/lambdas raise), and anything pickled
        # BY REFERENCE into __main__ — resolvable in this process but not
        # in a worker process, where cloudpickle's by-value pickling is
        # required (same split cloudpickle itself makes).
        f = io.BytesIO()
        plain(f, protocol=5, buffer_callback=buffers.append).dump(obj)
        pkl = f.getvalue()
        if b"__main__" in pkl or b"__mp_main__" in pkl:
            raise ValueError("main-module reference")
    except Exception:  # noqa: BLE001
        buffers.clear()
        f = io.BytesIO()
        cloud(f, protocol=5, buffer_callback=buffers.append).dump(obj)
        pkl = f.getvalue()
    views = [b.raw() for b in buffers]
    flags = FLAG_ERROR if is_error else 0
    head = _HEADER.pack(MAGIC, 1, flags, len(views), len(pkl))
    lens = struct.pack(f"<{len(views)}Q", *(len(v) for v in views)) if views else b""
    return head + lens + pkl, views


def serialized_size(meta: bytes, buffers: List[memoryview]) -> int:
    total = len(meta)
    for v in buffers:
        total = _align(total) + len(v)
    return total


def write_to(buf: memoryview, meta: bytes, buffers: List[memoryview]) -> int:
    """Write the full serialized object into `buf`; returns bytes written."""
    off = len(meta)
    buf[:off] = meta
    for v in buffers:
        off = _align(off)
        buf[off : off + len(v)] = v
        off += len(v)
    return off


_PAD64 = bytes(64)


def iov_parts(meta: bytes, buffers: List[memoryview]) -> List[memoryview]:
    """The serialized layout as an iovec — byte-identical to what
    `write_to` produces, but as a list of views the store's direct-write
    fast path hands straight to write() without materializing a
    contiguous copy."""
    parts = [memoryview(meta)]
    off = len(meta)
    for v in buffers:
        pad = _align(off) - off
        if pad:
            parts.append(memoryview(_PAD64)[:pad])
        parts.append(memoryview(v))
        off = _align(off) + len(v)
    return parts


def concat(meta: bytes, buffers: List[memoryview]) -> bytes:
    """Materialize the serialized layout as one contiguous bytes (the
    inline-reply path; large objects should go through put_serialized /
    iov_parts instead — no contiguous intermediate)."""
    if not buffers:
        return meta  # head + pickle, nothing to align
    out = io.BytesIO()
    out.write(meta)
    off = len(meta)
    for v in buffers:
        pad = _align(off) - off
        out.write(b"\x00" * pad)
        out.write(v)
        off = _align(off) + len(v)
    return out.getvalue()


def dumps(obj: Any, *, is_error: bool = False) -> bytes:
    meta, buffers = serialize(obj, is_error=is_error)
    return concat(meta, buffers)


def deserialize(data) -> Any:
    """Deserialize from bytes/memoryview. Zero-copy: out-of-band buffers are
    memoryview slices of `data` (keep the backing mmap alive via the views)."""
    view = memoryview(data)
    magic, version, flags, nbufs, pkl_len = _HEADER.unpack_from(view, 0)
    if magic != MAGIC:
        raise ValueError("corrupt object: bad magic")
    off = _HEADER.size
    lens = struct.unpack_from(f"<{nbufs}Q", view, off) if nbufs else ()
    off += 8 * nbufs
    pkl = view[off : off + pkl_len]
    off += pkl_len
    bufs = []
    for ln in lens:
        off = _align(off)
        bufs.append(view[off : off + ln])
        off += ln
    obj = pickle.loads(pkl, buffers=bufs)
    if flags & FLAG_ERROR:
        raise obj
    return obj


def is_error_payload(data) -> bool:
    view = memoryview(data)
    _, _, flags, _, _ = _HEADER.unpack_from(view, 0)
    return bool(flags & FLAG_ERROR)
