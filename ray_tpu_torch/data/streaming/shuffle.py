"""All-to-all shuffle over the transfer plane, counterpart of
`ray_tpu/data/streaming/shuffle.py`.

Every mapper emits ONE sealed *bundle*: all of its reducer partitions
packed back to back behind a fixed-size offset header, so a reader can take
one partition's byte range without touching the rest. On a cluster of
several nodes each bundle is first broadcast to every node over the daemon
relay tree (`broadcast_object`), so reducers find their input node-local.

The JAX package's partitions are Arrow IPC streams. Here each partition is a
self-describing frame (`block_to_frame`): its column names, dtypes and
shapes, then each numeric column's raw bytes; object columns are pickled.
`block_to_frame`/`frame_to_block`/`part_block` take the places of
`table_to_ipc`/`ipc_to_table`/`part_table`. A bundle is a uint8 array, so it
goes into the store out of band and a reducer reads it without a copy.

The mapper and reducer make the same numpy RNG calls in the same order as
JAX's, so a seeded shuffle of the same blocks gives the same row order.
"""
from __future__ import annotations

import json
import logging
import pickle
import struct
import time
from typing import Any, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, concat, num_rows, take

logger = logging.getLogger(__name__)

_MAGIC = b"RTSB"
_HEAD = struct.Struct("<4sI")      # magic, n_parts
_SLOT = struct.Struct("<QQ")       # offset, length
_FRAME_MAGIC = b"RTBF"
_FRAME = struct.Struct("<4sI")     # magic, header length


def header_size(n_parts: int) -> int:
    return _HEAD.size + n_parts * _SLOT.size


def block_to_frame(block: Block) -> bytes:
    """One partition as a frame: a JSON header of (name, dtype, shape,
    length, encoding) per column, then the columns' bytes in that order."""
    cols, payloads = [], []
    for name, v in block.items():
        if v.dtype == object:
            data, enc = pickle.dumps(v, protocol=5), "pickle"
        else:
            data = memoryview(np.ascontiguousarray(v).reshape(-1).view(np.uint8))
            enc = "raw"
        cols.append([name, v.dtype.str, list(v.shape), len(data), enc])
        payloads.append(data)
    header = json.dumps({"rows": num_rows(block), "cols": cols}).encode()
    return b"".join([_FRAME.pack(_FRAME_MAGIC, len(header)), header, *payloads])


def frame_to_block(buf) -> Block:
    buf = memoryview(buf).cast("B")
    magic, hlen = _FRAME.unpack_from(buf, 0)
    if magic != _FRAME_MAGIC:
        raise ValueError("not a block frame (bad magic)")
    pos = _FRAME.size
    header = json.loads(bytes(buf[pos:pos + hlen]))
    pos += hlen
    out = {}
    for name, dtype, shape, length, enc in header["cols"]:
        data = buf[pos:pos + length]
        if enc == "pickle":
            out[name] = pickle.loads(data)
        else:
            out[name] = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
        pos += length
    return out


def pack_bundle(parts: List[bytes]) -> np.ndarray:
    """Offset-addressed bundle: header with (offset, length) per part,
    payloads concatenated — the layout range readers slice into."""
    n = len(parts)
    off = header_size(n)
    slots = []
    for p in parts:
        slots.append((off, len(p)))
        off += len(p)
    out = np.empty(off, dtype=np.uint8)
    view = memoryview(out)
    _HEAD.pack_into(view, 0, _MAGIC, n)
    pos = _HEAD.size
    for s in slots:
        _SLOT.pack_into(view, pos, *s)
        pos += _SLOT.size
    for (o, ln), p in zip(slots, parts):
        view[o:o + ln] = p
    return out


def parse_header(buf) -> List[Tuple[int, int]]:
    magic, n = _HEAD.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise ValueError("not a shuffle bundle (bad magic)")
    return [_SLOT.unpack_from(buf, _HEAD.size + i * _SLOT.size)
            for i in range(n)]


def unpack_part(buf, j: int) -> memoryview:
    off, ln = parse_header(buf)[j]
    return memoryview(buf).cast("B")[off:off + ln]


def part_block(bundle, j: int) -> Block:
    return frame_to_block(unpack_part(bundle, j))


# -- remote shuffle stages ------------------------------------------------

def _scatter_bundle(block: Block, n: int, seed: int):
    """Mapper: permute rows, split into n partitions, pack ONE bundle.
    Second return is the bundle size — a tiny inline object, so the
    driver can account shuffle bytes without fetching a bundle."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(num_rows(block))
    parts = np.array_split(idx, n)
    bundle = pack_bundle([block_to_frame(take(block, p)) for p in parts])
    return bundle, len(bundle)


def _combine_part(seed: int, j: int, *bundles) -> Block:
    """Reducer: partition j of every bundle, concatenated + permuted."""
    t = concat([part_block(b, j) for b in bundles])
    rng = np.random.default_rng(seed)
    return take(t, rng.permutation(num_rows(t)))


def _prestage(bundle_refs: List[Any], fanout: int) -> int:
    """Broadcast each sealed bundle to every live node over the relay
    tree so reducers read node-locally. Best-effort: a failed prestage
    only costs the reducer a remote pull. Returns nodes staged."""
    try:
        from ray_tpu_torch.api import _global_worker

        worker = _global_worker()
        node_ids = [n["node_id"] for n in worker.nodes()
                    if n.get("alive", True)]
        if len(node_ids) <= 1:
            return 0
        staged = 0
        for ref in bundle_refs:
            res = worker.broadcast_object(ref, node_ids)
            staged += int(res.get("nodes", 0)) if res.get("ok") else 0
        return staged
    except Exception:  # noqa: BLE001 — prestage is an optimization
        logger.debug("shuffle prestage skipped", exc_info=True)
        return 0


def streaming_shuffle_refs(refs: List[Any],
                           seed: Optional[int] = None,
                           dataset: str = "ds") -> List[Any]:
    """ref_fn body for the streaming RandomShuffle barrier: bundles out
    of mappers, relay-tree prestage, per-partition reducers."""
    from ray_tpu_torch.core.config import get_config

    refs = list(refs)
    if not refs:
        return refs
    n_out = len(refs)
    cfg = get_config()
    fanout = (cfg.data_stream_shuffle_fanout
              or cfg.transfer_broadcast_fanout)

    scatter = ray_tpu_torch.remote(_scatter_bundle).options(num_returns=2)
    combine = ray_tpu_torch.remote(_combine_part)

    ss = np.random.SeedSequence(seed)
    seeds = ss.generate_state(len(refs) + n_out)
    t0 = time.monotonic()
    bundles, sizes = [], []
    for i, r in enumerate(refs):
        b, s = scatter.remote(r, n_out, int(seeds[i]))
        bundles.append(b)
        sizes.append(s)
    # Bundles must be sealed before they can relay; the wait doubles as
    # the mapper barrier every all-to-all has anyway.
    ray_tpu_torch.wait(bundles, num_returns=len(bundles))
    _prestage(bundles, fanout)
    out = [combine.remote(int(seeds[len(refs) + j]), j, *bundles)
           for j in range(n_out)]
    ray_tpu_torch.wait(out, num_returns=len(out))
    elapsed = time.monotonic() - t0
    try:
        from ray_tpu_torch.data.streaming import metrics as dm

        dm.on_shuffle(dataset, sum(ray_tpu_torch.get(sizes)), elapsed)
    except Exception:  # noqa: BLE001
        pass
    return out
