"""Dataset: lazy, immutable, distributed collection of blocks, counterpart
of `ray_tpu/data/dataset.py`.

Reference surface being reproduced (ref: python/ray/data/dataset.py:137 —
map_batches :371, iter_batches :3640, materialize :4520; grouped_data.py;
_internal/split.py).  Execution is deferred: transforms append stages to a
logical plan; consumption streams block refs through the executor.

The blocks are numpy columns (`data/block.py`), so what the JAX package
does with Arrow's kernels is done here in numpy, with Arrow's results:
`sort` is a stable sort (ties keep their input order, NaN then nulls last,
in both directions); the aggregates skip nulls, give Arrow's types and
output names ("<col>_<fn>"), and accept the option specs of the functions
they compute. `iter_device_batches` is the counterpart of
`iter_jax_batches`: `data/feed.py::torch_feed` over the numpy batches.
"""
from __future__ import annotations

import functools
import itertools
import json
import math
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.execution import execute
from ray_tpu_torch.data.plan import AllToAllStage, MapStage, ReadTask

BatchUDF = Callable[..., Any]


def _batch_map_blockfn(fn, batch_size, batch_format, fn_kwargs):
    def block_fn(block: B.Block) -> Iterable[B.Block]:
        for piece in B.batches(block, batch_size):
            out = fn(B.to_batch(piece, batch_format), **fn_kwargs)
            yield B.from_batch(out)

    return block_fn


def _row_map_blockfn(kind: str, fn):
    def block_fn(block: B.Block) -> Iterable[B.Block]:
        rows = list(B.iter_rows(block))
        if kind == "map":
            out = [fn(r) for r in rows]
        elif kind == "filter":
            out = [r for r in rows if fn(r)]
        else:  # flat_map
            out = list(itertools.chain.from_iterable(fn(r) for r in rows))
        if not out:
            yield B.slice_block(block, 0, 0)
            return
        yield B.from_rows(out)

    return block_fn


def _rebatch(block_iter: Iterable[B.Block], batch_size: int,
             batch_format: Optional[str], drop_last: bool) -> Iterator[Any]:
    """Re-slice a block stream into fixed-size batches."""
    carry: Optional[B.Block] = None
    for blk in block_iter:
        if carry is not None and B.num_rows(carry):
            blk = B.concat([carry, blk])
            carry = None
        start, n = 0, B.num_rows(blk)
        while n - start >= batch_size:
            yield B.to_batch(B.slice_block(blk, start, start + batch_size),
                             batch_format)
            start += batch_size
        carry = B.slice_block(blk, start, n)
    if carry is not None and B.num_rows(carry) and not drop_last:
        yield B.to_batch(carry, batch_format)


def _device_feed(batch_iter: Iterator[dict], device, mesh, dtypes,
                 prefetch: Optional[int], name: str):
    """Shared device feed for Dataset / streaming-split iterators:
    `torch_feed` (dtype cast, pinned staging, a side-stream copy) behind a
    prefetcher of the configured depth (RAY_TPU_DATA_STREAM_PREFETCH_DEPTH
    when `prefetch` is None)."""
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.data.feed import torch_feed

    depth = (get_config().data_stream_prefetch_depth
             if prefetch is None else prefetch)
    return torch_feed(batch_iter, device=device, mesh=mesh, dtypes=dtypes,
                      prefetch=depth, name=name)


def _torch_batches(batch_iter: Iterator[dict]) -> Iterator[dict]:
    """numpy batches → torch tensors (copying read-only shm views;
    torch needs writable memory for in-place training ops)."""
    import torch

    for batch in batch_iter:
        yield {k: torch.as_tensor(
                   v if getattr(v, "flags", None) is None
                   or v.flags.writeable else np.array(v))
               for k, v in batch.items()}


# -- numpy counterparts of the Arrow compute kernels the JAX package calls --

def _valid(col: np.ndarray) -> np.ndarray:
    """A column's non-null values (None dropped; NaN is a value)."""
    if col.dtype != object:
        return col
    return B.column([x for x in col if x is not None])


def _py(x):
    return x.item() if isinstance(x, np.generic) else x


def _not_nan(v: np.ndarray) -> np.ndarray:
    return v[~np.isnan(v)] if v.dtype.kind == "f" else v


def _order_key(v):
    """Arrow's order of values: numbers and strings, then NaN, then null."""
    if v is None:
        return (2, 0)
    if isinstance(v, float) and v != v:
        return (1, 0)
    return (0, v)


def _argsort(keys: np.ndarray, descending: bool = False) -> np.ndarray:
    """Arrow's `sort_indices` on one column: stable (ties keep their input
    order, also descending), NaN and then nulls at the end."""
    n = len(keys)
    if keys.dtype != object and keys.ndim == 1:
        nan = np.isnan(keys) if keys.dtype.kind == "f" else np.zeros(n, bool)
        idx = np.flatnonzero(~nan)
        vals = keys[idx]
        if descending:
            order = np.argsort(vals[::-1], kind="stable")
            order = (len(vals) - 1 - order)[::-1]
        else:
            order = np.argsort(vals, kind="stable")
        return np.concatenate([idx[order], np.flatnonzero(nan)]).astype(np.int64)
    vals = keys.tolist()
    tail = sorted((i for i, v in enumerate(vals) if _order_key(v)[0]),
                  key=lambda i: _order_key(vals[i])[0])
    head = sorted((i for i, v in enumerate(vals) if not _order_key(v)[0]),
                  key=lambda i: vals[i], reverse=descending)
    return np.asarray(head + tail, dtype=np.int64)


def _sort_block(block: B.Block, key: str, descending: bool) -> B.Block:
    return B.take(block, _argsort(block[key], descending))


def _sum(v):
    return _py(v.sum()) if len(v) else None


def _product(v):
    return _py(v.prod()) if len(v) else None


def _mean(v):
    return float(v.astype(np.float64).mean()) if len(v) else None


def _extreme(fn):
    def agg(v):
        if v.dtype == object:
            return fn(v.tolist()) if len(v) else None
        w = _not_nan(v)
        if len(w):
            return _py(w.min() if fn is min else w.max())
        return float("nan") if len(v) else None
    return agg


def _variance(v, ddof: int = 0):
    n = len(v)
    if n <= ddof:
        return None
    x = v.astype(np.float64)
    return float(((x - x.mean()) ** 2).sum() / (n - ddof))


def _stddev(v, ddof: int = 0):
    var = _variance(v, ddof)
    return None if var is None else math.sqrt(var)


def _count_distinct(v):
    seen = {("nan",) if isinstance(x, float) and x != x else x for x in v.tolist()}
    return len(seen)


# fn -> (computation over the non-null values, whether the output is float64,
#        the option spec it takes: (options class, {option: aggregate kwarg}))
_AGGS = {
    "sum": (_sum, False, ("ScalarAggregateOptions", {})),
    "product": (_product, False, ("ScalarAggregateOptions", {})),
    "mean": (_mean, True, ("ScalarAggregateOptions", {})),
    "min": (_extreme(min), False, ("ScalarAggregateOptions", {})),
    "max": (_extreme(max), False, ("ScalarAggregateOptions", {})),
    "count": (len, False, ("CountOptions", {})),
    "count_distinct": (_count_distinct, False, ("CountOptions", {})),
    "stddev": (_stddev, True, ("VarianceOptions", {"ddof": "ddof"})),
    "variance": (_variance, True, ("VarianceOptions", {"ddof": "ddof"})),
    "first": (lambda v: _py(v[0]) if len(v) else None, False,
              ("ScalarAggregateOptions", {})),
    "last": (lambda v: _py(v[-1]) if len(v) else None, False,
             ("ScalarAggregateOptions", {})),
}


def _aggregator(spec: tuple):
    """(col, fn[, ("OptionsClass", kwargs)]) -> (col, output name, compute,
    float output). Raises ValueError for what the port does not compute."""
    col, fn = spec[0], spec[1]
    if fn not in _AGGS:
        raise ValueError(f"aggregate function {fn!r} is not computed by the "
                         f"port's numpy blocks (it computes {sorted(_AGGS)})")
    compute, is_float, (cls, accepted) = _AGGS[fn]
    kw = {}
    if len(spec) == 3:
        opts = spec[2]
        if not (isinstance(opts, tuple) and len(opts) == 2 and opts[0] == cls):
            raise ValueError(f"aggregate {fn!r} takes ({cls!r}, kwargs), not "
                             f"{opts!r}")
        for k, v in dict(opts[1]).items():
            if k not in accepted and not (cls == "CountOptions" and k == "mode"):
                raise ValueError(f"aggregate {fn!r}: option {k!r} of {cls} is "
                                 "not computed by the port")
            kw[accepted.get(k, k)] = v
    mode = kw.pop("mode", "only_valid")
    if mode not in ("only_valid", "only_null", "all"):
        raise ValueError(f"aggregate {fn!r}: CountOptions mode {mode!r}")

    def run(values: np.ndarray):
        if fn in ("count", "count_distinct") and mode != "only_valid":
            nulls = sum(x is None for x in values) if values.dtype == object else 0
            if fn == "count":
                return nulls if mode == "only_null" else len(values)
            if mode == "only_null":
                return min(nulls, 1)
            return _count_distinct(_valid(values)) + min(nulls, 1)
        return compute(_valid(values), **kw)

    return col, f"{col}_{fn}", run, is_float


def _out_column(values: List[Any], is_float: bool, like: np.ndarray) -> np.ndarray:
    """An aggregate's output column, typed as Arrow's: float64 outputs with
    NaN for null; others by their values, a numeric input's all-null output
    as float64 NaN."""
    if is_float or (all(v is None for v in values) and like.dtype != object):
        return np.asarray([np.nan if v is None else v for v in values], np.float64)
    return B.column(values)


def _group_rows(t: B.Block, keys: List[str]) -> Dict[tuple, List[int]]:
    """Row indices of each distinct key combination, in order of first
    appearance (Arrow's hash grouping; NaN keys form one group)."""
    groups: Dict[tuple, List[int]] = {}
    first: Dict[tuple, tuple] = {}
    cols = [t[k].tolist() for k in keys]
    for i, combo in enumerate(zip(*cols)):
        norm = tuple(("nan",) if isinstance(v, float) and v != v else v
                     for v in combo)
        if norm not in groups:
            groups[norm], first[norm] = [], combo
        groups[norm].append(i)
    return {first[k]: rows for k, rows in groups.items()}


def _key_column(values: List[Any], like: np.ndarray) -> np.ndarray:
    col = B.column(values)
    if col.dtype != object and like.dtype != object and col.dtype != like.dtype:
        col = col.astype(like.dtype)
    return col


class Dataset:
    def __init__(self, read_tasks: List[ReadTask], stages: List[Any] = None):
        self._read_tasks = read_tasks
        self._stages = stages or []

    # ---------------- transforms (lazy) ----------------
    def _with(self, stage) -> "Dataset":
        return Dataset(self._read_tasks, self._stages + [stage])

    def map_batches(self, fn: BatchUDF, *, batch_size: Optional[int] = None,
                    batch_format: Optional[str] = None,
                    compute: Optional[Any] = None, concurrency: int = 0,
                    fn_constructor_args: tuple = (),
                    fn_kwargs: Optional[dict] = None, **_ignored) -> "Dataset":
        """Apply a UDF per batch.  Class UDFs run on an actor pool
        (`concurrency` actors); function UDFs fuse into producer tasks."""
        fn_kwargs = fn_kwargs or {}
        if isinstance(fn, type):
            n = concurrency or (compute if isinstance(compute, int) else 2)

            def maker(cls=fn, args=fn_constructor_args, kw=dict(fn_kwargs),
                      bs=batch_size, bf=batch_format):
                inst = cls(*args)
                return _batch_map_blockfn(inst, bs, bf, kw)

            return self._with(MapStage(
                name=f"MapBatches({fn.__name__})",
                block_fn=None, actor_fn_maker=maker, num_actors=n))
        return self._with(MapStage(
            name=f"MapBatches({getattr(fn, '__name__', 'fn')})",
            block_fn=_batch_map_blockfn(fn, batch_size, batch_format,
                                        fn_kwargs)))

    def map(self, fn) -> "Dataset":
        return self._with(MapStage("Map", _row_map_blockfn("map", fn)))

    def filter(self, fn) -> "Dataset":
        return self._with(MapStage("Filter", _row_map_blockfn("filter", fn)))

    def flat_map(self, fn) -> "Dataset":
        return self._with(MapStage("FlatMap",
                                   _row_map_blockfn("flat_map", fn)))

    def add_column(self, name: str, fn) -> "Dataset":
        def add(batch):
            batch[name] = fn(batch)
            return batch

        return self.map_batches(add, batch_format="numpy")

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(
            lambda b: {k: v for k, v in b.items() if k not in cols},
            batch_format="numpy")

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(lambda b: {k: b[k] for k in cols},
                                batch_format="numpy")

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self.map_batches(
            lambda b: {mapping.get(k, k): v for k, v in b.items()},
            batch_format="numpy")

    def limit(self, n: int) -> "Dataset":
        # Streaming cutoff: pulls upstream refs only until n rows are seen,
        # so execution of the tail never happens.
        def ref_fn(ref_iter):
            def gen():
                left = n
                for ref in ref_iter:
                    if left <= 0:
                        break
                    blk = ray_tpu_torch.get(ref)
                    rows = B.num_rows(blk)
                    take = min(left, rows)
                    left -= take
                    yield (ref if take == rows
                           else ray_tpu_torch.put(B.slice_block(blk, 0, take)))

            return gen()

        return self._with(AllToAllStage("Limit", ref_fn))

    # ---------------- all-to-all ----------------
    def repartition(self, num_blocks: int) -> "Dataset":
        def ref_fn(refs):
            refs = list(refs)
            if not refs:
                return refs
            blocks = ray_tpu_torch.get(refs)
            whole = B.concat(blocks)
            n = B.num_rows(whole)
            per = max(1, -(-n // num_blocks))
            return [ray_tpu_torch.put(B.slice_block(whole, i * per, (i + 1) * per))
                    for i in range(num_blocks) if i * per < n or n == 0]

        return self._with(AllToAllStage("Repartition", ref_fn))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Distributed map-reduce shuffle: each block scatters rows into
        num_blocks partitions; reducers concat+permute
        (ref: data/_internal shuffle — push-based variant not needed yet).

        On the streaming path every mapper packs its partitions into ONE
        offset-addressed bundle (see data/streaming/shuffle.py) instead of
        N² point-to-point pickled gets."""
        def streaming_ref_fn(refs):
            from ray_tpu_torch.data.streaming.shuffle import streaming_shuffle_refs

            return streaming_shuffle_refs(refs, seed, self._name())

        def ref_fn(refs):
            from ray_tpu_torch.data.streaming import streaming_enabled

            if streaming_enabled():
                return streaming_ref_fn(refs)
            refs = list(refs)
            if not refs:
                return refs
            n_out = len(refs)

            @ray_tpu_torch.remote
            def scatter(block, n, s):
                rng = np.random.default_rng(s)
                idx = rng.permutation(B.num_rows(block))
                parts = np.array_split(idx, n)
                out = tuple(B.take(block, p) for p in parts)
                return out[0] if n == 1 else out

            @ray_tpu_torch.remote
            def combine(s, *parts):
                t = B.concat(list(parts))
                rng = np.random.default_rng(s)
                return B.take(t, rng.permutation(B.num_rows(t)))

            ss = np.random.SeedSequence(seed)
            seeds = ss.generate_state(2 * len(refs) + n_out)
            scattered = [
                scatter.options(num_returns=n_out).remote(r, n_out,
                                                          int(seeds[i]))
                for i, r in enumerate(refs)]
            if n_out == 1:
                scattered = [[s] for s in scattered]
            return [combine.remote(int(seeds[len(refs) + j]),
                                   *[scattered[i][j]
                                     for i in range(len(refs))])
                    for j in range(n_out)]

        return self._with(AllToAllStage("RandomShuffle", ref_fn))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed range-partition sort (ref: _internal/planner/
        exchange/sort_task_spec.py:1 SortTaskSpec — sample → boundaries →
        per-block partition map → per-range merge). No task ever holds
        more than ~1/num_blocks of the data. Each sort is stable, as
        Arrow's `sort_by` is."""
        def ref_fn(refs):
            refs = list(refs)
            if not refs:
                return refs
            n_out = len(refs)

            @ray_tpu_torch.remote
            def sort_block(b):
                return _sort_block(b, key, descending) if B.num_rows(b) else b

            if n_out == 1:
                return [sort_block.remote(refs[0])]

            # 1) Sample boundary candidates from every block.
            @ray_tpu_torch.remote
            def sample_keys(block, k=64):
                n = B.num_rows(block)
                if n == 0:
                    return None
                idx = np.linspace(0, n - 1, min(k, n)).astype(np.int64)
                return block[key][idx]

            samples = [s for s in ray_tpu_torch.get(
                [sample_keys.remote(r) for r in refs]) if s is not None]
            if not samples:
                return refs
            allsamp = np.concatenate(samples)
            allsamp = allsamp[_argsort(allsamp)]
            cut_idx = np.linspace(0, allsamp.size - 1,
                                  n_out + 1).astype(np.int64)[1:-1]
            bounds = allsamp[cut_idx]

            # 2) Partition map: each block splits into n_out key ranges
            # (always ascending; descending flips the range order below).
            @ray_tpu_torch.remote
            def partition(block, bnds, n):
                sb = _sort_block(block, key, False)
                keys = sb[key] if sb else np.empty(0)
                cuts = np.searchsorted(keys, bnds, side="left")
                edges = [0, *cuts.tolist(), B.num_rows(sb)]
                parts = tuple(B.slice_block(sb, edges[i], edges[i + 1])
                              for i in range(n))
                return parts[0] if n == 1 else parts

            # 3) Per-range merge: concat this range's shards + local sort.
            @ray_tpu_torch.remote
            def merge(*parts):
                return _sort_block(B.concat(list(parts)), key, descending) \
                    if any(B.num_rows(p) for p in parts) else {}

            parted = [partition.options(num_returns=n_out)
                      .remote(r, bounds, n_out) for r in refs]
            out = [merge.remote(*[parted[i][j] for i in range(len(refs))])
                   for j in range(n_out)]
            return out[::-1] if descending else out

        return self._with(AllToAllStage("Sort", ref_fn))

    def groupby(self, key) -> "GroupedData":
        """Group by one column or a LIST of columns (ref:
        python/ray/data/grouped_data.py multi-key groupby)."""
        return GroupedData(self, key)

    def union(self, other: "Dataset") -> "Dataset":
        if self._stages or other._stages:
            left = self.materialize()
            right = other.materialize()
            return Dataset(left._read_tasks + right._read_tasks)
        return Dataset(self._read_tasks + other._read_tasks)

    def zip(self, other: "Dataset") -> "Dataset":
        def ref_fn(refs):
            mine = B.concat(ray_tpu_torch.get(list(refs)))
            theirs = B.concat(ray_tpu_torch.get(list(other.to_block_refs())))
            n = min(B.num_rows(mine), B.num_rows(theirs))
            mine, theirs = B.slice_block(mine, 0, n), B.slice_block(theirs, 0, n)
            cols = dict(mine)
            for c, v in theirs.items():
                cols[c if c not in cols else f"{c}_1"] = v
            return [ray_tpu_torch.put(cols)]

        return self._with(AllToAllStage("Zip", ref_fn))

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        # Per-call entropy when unseeded; per-block entropy from a content
        # digest so equal-sized blocks don't draw identical masks.
        import secrets
        import zlib

        call_entropy = seed if seed is not None else secrets.randbits(63)

        def block_fn(block):
            digest, n = 0, B.num_rows(block)
            if block and n:
                first = next(iter(block.values()))
                data = (repr(first[:64].tolist()).encode() if first.dtype == object
                        else np.ascontiguousarray(first).reshape(-1)
                        .view(np.uint8)[:4096].tobytes())
                digest = zlib.crc32(data)
            rng = np.random.default_rng((call_entropy, digest, n))
            mask = rng.random(n) < fraction
            yield {k: v[mask] for k, v in block.items()}

        return self._with(MapStage("RandomSample", block_fn))

    # ---------------- split ----------------
    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """Materialize and split into n datasets (ref: dataset.py split;
        used for per-host train shards)."""
        refs = list(self.to_block_refs())
        blocks = ray_tpu_torch.get(refs)
        whole = B.concat(blocks)
        total = B.num_rows(whole)
        per = total // n if equal else -(-total // n)
        out = []
        for i in range(n):
            start = min(i * per, total)
            end = min((i + 1) * per, total) if i < n - 1 or equal else total
            t = B.slice_block(whole, start, max(start, end))
            out.append(from_block_list([t]))
        return out

    def streaming_split(self, n: int, *, equal: bool = False
                        ) -> List["StreamingSplitIterator"]:
        """N per-consumer iterators over ONE streaming execution of this
        dataset (ref: _internal/execution/operators/output_splitter.py:1
        OutputSplitter + Dataset.streaming_split — the multi-worker Train
        ingest path). Blocks are handed out first-come-first-served by a
        coordinator actor; `equal=True` instead enforces round-robin
        handout (consumers advance in lockstep).

        On the streaming path the coordinator is the ack-based
        StreamSplitCoordinator (data/streaming/split.py): it tracks one
        outstanding block per consumer and supports live resplit() on
        elastic world-size change — no epoch restart, no lost or
        duplicated samples."""
        from ray_tpu_torch.data.streaming import streaming_enabled

        if streaming_enabled():
            from ray_tpu_torch.data.streaming.split import StreamSplitCoordinator

            coord = StreamSplitCoordinator.remote(self, n, equal)
        else:
            coord = _SplitCoordinator.remote(self, n, equal)
        return [StreamingSplitIterator(coord, i) for i in range(n)]

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        whole = B.concat(ray_tpu_torch.get(list(self.to_block_refs())))
        bounds = [0] + list(indices) + [B.num_rows(whole)]
        return [from_block_list([B.slice_block(whole, a, b)])
                for a, b in zip(bounds[:-1], bounds[1:])]

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        whole = B.concat(ray_tpu_torch.get(list(ds.to_block_refs())))
        n = B.num_rows(whole)
        cut = int(n * (1 - test_size))
        return (from_block_list([B.slice_block(whole, 0, cut)]),
                from_block_list([B.slice_block(whole, cut, n)]))

    # ---------------- execution / consumption ----------------
    def to_block_refs(self) -> Iterator[Any]:
        from ray_tpu_torch.data.stats import DatasetStats
        from ray_tpu_torch.data.streaming import streaming_enabled, streaming_execute

        self._last_stats = DatasetStats()
        if streaming_enabled():
            # Default path: byte-budgeted streaming operator graph
            # (RAY_TPU_DATA_STREAM_ENABLED=0 falls back to the legacy
            # block-materializing executor).
            try:
                yield from streaming_execute(self._read_tasks, self._stages,
                                             stats=self._last_stats)
            finally:
                from ray_tpu_torch.data.streaming import metrics as _dm

                _dm.on_execution(self._name(), self._last_stats)
            return
        yield from execute(self._read_tasks, self._stages,
                           stats=self._last_stats)

    def _name(self) -> str:
        return getattr(self, "_label", "ds")

    def iter_blocks(self) -> Iterator[B.Block]:
        for ref in self.to_block_refs():
            blk = ray_tpu_torch.get(ref)
            stats = getattr(self, "_last_stats", None)
            if stats is not None:
                stats.consumed_rows += B.num_rows(blk)
                stats.consumed_bytes += B.size_bytes(blk)
            yield blk

    def stats(self) -> str:
        """Execution stats of the most recent consumption (ref:
        Dataset.stats(), data/_internal/stats.py)."""
        stats = getattr(self, "_last_stats", None)
        if stats is None:
            return "Dataset has not been executed yet."
        return stats.summary()

    def materialize(self) -> "Dataset":
        refs = list(self.to_block_refs())
        return _materialized(refs)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: Optional[str] = None,
                     prefetch_batches: int = 1,
                     drop_last: bool = False) -> Iterator[Any]:
        yield from _rebatch(self.iter_blocks(), batch_size, batch_format,
                            drop_last)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False) -> Iterator[dict]:
        """Batches as torch tensors (ref: Dataset.iter_torch_batches)."""
        yield from _torch_batches(self.iter_batches(
            batch_size=batch_size, batch_format="numpy",
            drop_last=drop_last))

    def iter_rows(self) -> Iterator[Any]:
        for blk in self.iter_blocks():
            yield from B.iter_rows(blk)

    def take(self, n: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(B.num_rows(b) for b in self.iter_blocks())

    def sum(self, col: str):
        return sum(_sum(_valid(b[col])) or 0 for b in self.iter_blocks())

    def min(self, col: str):
        return min(_extreme(min)(_valid(b[col])) for b in self.iter_blocks())

    def max(self, col: str):
        return max(_extreme(max)(_valid(b[col])) for b in self.iter_blocks())

    def mean(self, col: str):
        total, cnt = 0.0, 0
        for b in self.iter_blocks():
            total += _sum(_valid(b[col])) or 0
            cnt += B.num_rows(b)
        return total / cnt if cnt else float("nan")

    def std(self, col: str, ddof: int = 1):
        """Streaming standard deviation (Chan parallel-variance merge
        across blocks — no global materialization)."""
        count, mean, m2 = 0, 0.0, 0.0
        for b in self.iter_blocks():
            # Weight by VALID values — nulls carry no mass.
            v = _valid(b[col])
            n = len(v)
            if not n:
                continue
            bm = _mean(v)
            bv = _variance(v, 0) or 0.0
            delta = bm - mean
            total = count + n
            m2 += bv * n + delta * delta * count * n / total
            mean += delta * n / total
            count = total
        if count <= ddof:
            return float("nan")
        return float(np.sqrt(m2 / (count - ddof)))

    def quantile(self, col: str, q: float = 0.5):
        """Exact quantile (linear interpolation; nulls and NaN skipped, as
        Arrow's); pulls only the ONE column to the driver."""
        chunks = [_valid(b[col]) for b in self.iter_blocks() if B.num_rows(b)]
        if not chunks:
            return float("nan")
        values = _not_nan(np.concatenate(chunks).astype(np.float64))
        return float(np.quantile(values, q)) if len(values) else None

    def unique(self, col: str) -> List[Any]:
        """Distinct values of a column, streamed block by block (each
        block's in order of first appearance, as Arrow's `unique`)."""
        seen: set = set()
        for b in self.iter_blocks():
            seen.update(dict.fromkeys(b[col].tolist()))
        return sorted(seen, key=lambda v: (v is None, v))

    def schema(self) -> Optional[B.Schema]:
        for b in self.iter_blocks():
            return B.schema(b)
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s else []

    def num_blocks(self) -> int:
        return len(list(self.to_block_refs()))

    def size_bytes(self) -> int:
        return sum(B.size_bytes(b) for b in self.iter_blocks())

    def to_pandas(self):
        return B.to_pandas(B.concat(list(self.iter_blocks())))

    def to_arrow(self):
        return B.to_arrow(B.concat(list(self.iter_blocks())))

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return B.to_numpy(B.concat(list(self.iter_blocks())))

    # ---------------- writes ----------------
    def write_parquet(self, path: str) -> None:
        self._write(path, "parquet")

    def write_csv(self, path: str) -> None:
        self._write(path, "csv")

    def write_json(self, path: str) -> None:
        self._write(path, "json")

    def write_tfrecords(self, path: str) -> None:
        """One .tfrecords file per block, rows encoded as
        tf.train.Example via the built-in codec (ref: Dataset.
        write_tfrecords)."""
        import os

        from ray_tpu_torch.data import tfrecord

        os.makedirs(path, exist_ok=True)
        for i, blk in enumerate(self.iter_blocks()):
            f = os.path.join(path, f"part-{i:05d}.tfrecords")
            tfrecord.write_records(
                f, (tfrecord.encode_example(row)
                    for row in B.iter_rows(blk)))

    def write_mongo(self, *, database: str, collection: str,
                    uri: Optional[str] = None,
                    client_factory=None) -> None:
        """Insert every row into a MongoDB collection (ref: datasource/
        mongo_datasource.py write path). `client_factory` is the same
        injectable seam as `read_mongo`. Blocks stream through the
        DRIVER sequentially."""
        if client_factory is None:
            def client_factory():  # pragma: no cover - needs a mongod
                import pymongo

                return pymongo.MongoClient(uri)

        client = client_factory()
        try:
            coll = client[database][collection]
            for blk in self.iter_blocks():
                rows = [dict(r) for r in B.iter_rows(blk)]
                if rows:
                    coll.insert_many(rows)
        finally:
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass

    def write_bigquery(self, *, dataset: str,
                       project_id: Optional[str] = None,
                       client_factory=None) -> None:
        """Load every block into a BigQuery table (ref: datasource/
        bigquery_datasource.py write path); `dataset` is
        "dataset.table"."""
        if client_factory is None:
            def client_factory():  # pragma: no cover - needs GCP creds
                from google.cloud import bigquery

                return bigquery.Client(project=project_id)

        client = client_factory()
        try:
            for blk in self.iter_blocks():
                job = client.load_table_from_dataframe(B.to_pandas(blk),
                                                       dataset)
                job.result()
        finally:
            try:
                client.close()
            except Exception:  # noqa: BLE001 fakes without close()
                pass

    def _write(self, path: str, fmt: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        for i, blk in enumerate(self.iter_blocks()):
            f = os.path.join(path, f"part-{i:05d}.{fmt}")
            if fmt == "parquet":
                import pyarrow.parquet as pq

                pq.write_table(B.to_arrow(blk), f)
            elif fmt == "csv":
                import pyarrow.csv as pcsv

                pcsv.write_csv(B.to_arrow(blk), f)
            else:
                with open(f, "w") as fh:
                    for row in B.iter_rows(blk):
                        row = row if isinstance(row, dict) else {"item": row}
                        fh.write(json.dumps({k: _jsonable(v) for k, v in row.items()})
                                 + "\n")

    # ---------------- device feeding ----------------
    def iter_device_batches(self, *, batch_size: int, device="cuda", mesh=None,
                            dtypes: Optional[dict] = None, drop_last: bool = True,
                            prefetch: Optional[int] = None):
        """Batches on `device` (the card unless the caller passes a CPU
        device), `prefetch` of them copied ahead of the consumer by
        `data/feed.py::torch_feed`: pinned staging and a side-stream copy,
        so the copy of batch k+1 overlaps compute on batch k. Under a
        `mesh` each rank gets a DTensor of the global batch holding its
        rows. Returns the feed: iterate it, and use it as a context
        manager (or `close()` it) to leave before the end."""
        return _device_feed(
            self.iter_batches(batch_size=batch_size, batch_format="numpy",
                              drop_last=drop_last),
            device, mesh, dtypes, prefetch, self._name())

    def __repr__(self):
        names = [getattr(s, "name", "?") for s in self._stages]
        return (f"Dataset(blocks~{len(self._read_tasks)}, "
                f"stages={names})")


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return [_jsonable(x) for x in v.tolist()]
    v = _py(v)
    if isinstance(v, float) and v != v:
        return None
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    return v


@ray_tpu_torch.remote(num_cpus=0)
class _SplitCoordinator:
    """Hands one streaming execution's block refs out to N consumers
    (ref: output_splitter.py OutputSplitter). Lives in an actor so every
    consumer — typically a Train worker on another node — pulls from the
    SAME execution instead of re-executing the dataset per shard."""

    def __init__(self, dataset, n: int, equal: bool):
        self._n = n
        self._equal = equal
        self._it = iter(dataset.to_block_refs())
        self._queues: List[list] = [[] for _ in range(n)]
        self._next_rr = 0
        self._done = False

    def _pull(self):
        try:
            return next(self._it)
        except StopIteration:
            self._done = True
            return None

    def next_block(self, consumer_idx: int):
        """Next block ref for this consumer, or None when exhausted."""
        if not self._equal:
            return None if self._done else self._pull()
        q = self._queues[consumer_idx]
        while not q and not self._done:
            ref = self._pull()
            if ref is None:
                break
            self._queues[self._next_rr].append(ref)
            self._next_rr = (self._next_rr + 1) % self._n
        return q.pop(0) if q else None


class StreamingSplitIterator:
    """One consumer's shard of a streaming_split (ref: DataIterator,
    python/ray/data/iterator.py — the object handed to each Train
    worker). Pickles cleanly (actor handle + index), single pass.

    `block_timeout_s` bounds each next_block wait (None = wait forever,
    the default: the FIRST block legitimately waits on the whole
    upstream pipeline)."""

    def __init__(self, coord, idx: int,
                 block_timeout_s: Optional[float] = None):
        self._coord = coord
        self._idx = idx
        self._block_timeout_s = block_timeout_s

    def iter_blocks(self) -> Iterator[B.Block]:
        while True:
            ref = ray_tpu_torch.get(self._coord.next_block.remote(self._idx),
                                    timeout=self._block_timeout_s)
            if ref is None:
                return
            yield ray_tpu_torch.get(ref)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: Optional[str] = None,
                     drop_last: bool = False) -> Iterator[Any]:
        yield from _rebatch(self.iter_blocks(), batch_size, batch_format,
                            drop_last)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False) -> Iterator[dict]:
        yield from _torch_batches(self.iter_batches(
            batch_size=batch_size, batch_format="numpy",
            drop_last=drop_last))

    def iter_device_batches(self, *, batch_size: int, device="cuda", mesh=None,
                            dtypes: Optional[dict] = None,
                            drop_last: bool = True,
                            prefetch: Optional[int] = None):
        """Device-prefetched shard feed: the train-worker counterpart of
        Dataset.iter_device_batches."""
        return _device_feed(
            self.iter_batches(batch_size=batch_size, batch_format="numpy",
                              drop_last=drop_last),
            device, mesh, dtypes, prefetch, f"split-{self._idx}")

    def iter_rows(self) -> Iterator[Any]:
        for blk in self.iter_blocks():
            yield from B.iter_rows(blk)


class GroupedData:
    """Groupby-aggregate over one or many key columns (ref:
    python/ray/data/grouped_data.py — multi-key groupby, named
    aggregations, map_groups)."""

    def __init__(self, ds: Dataset, key):
        self._ds = ds
        self._keys: List[str] = [key] if isinstance(key, str) else \
            list(key)
        if not self._keys:
            raise ValueError("groupby needs at least one key column")

    def _agg(self, aggs: List[tuple]) -> Dataset:
        keys = self._keys
        specs = [_aggregator(a) for a in aggs]   # unknown functions raise here

        def ref_fn(refs):
            refs = list(refs)

            @ray_tpu_torch.remote
            def agg_all(*blocks):
                t = B.concat(list(blocks))
                if not B.num_rows(t):
                    return {}
                groups = _group_rows(t, keys)
                # One row per group, ordered by the keys ascending (Arrow's
                # group_by, then sort_by the keys): keys first, then each
                # aggregate as "<col>_<fn>".
                order = sorted(groups, key=lambda c: tuple(_order_key(v) for v in c))
                out = {k: _key_column([c[i] for c in order], t[k])
                       for i, k in enumerate(keys)}
                for col, name, run, is_float in specs:
                    vals = [run(t[col][np.asarray(groups[c])]) for c in order]
                    out[name] = _out_column(vals, is_float, t[col])
                return out

            return [agg_all.remote(*refs)]

        return self._ds._with(AllToAllStage("GroupByAgg", ref_fn))

    def aggregate(self, *aggs: tuple) -> Dataset:
        """Named aggregations: (col, fn) pairs — 'sum', 'product', 'mean',
        'min', 'max', 'count', 'count_distinct', 'stddev', 'variance',
        'first', 'last', the group-by functions of pyarrow the port
        computes — or (col, fn, ("OptionsClassName", kwargs)) triples, e.g.
        ("v", "stddev", ("VarianceOptions", {"ddof": 1})). Any other
        function or option raises ValueError. Multiple at once produce one
        row per group with a column per aggregate."""
        if not aggs:
            raise ValueError("aggregate() needs (col, fn) pairs")
        return self._agg(list(aggs))

    def count(self) -> Dataset:
        return self._agg([(self._keys[0], "count")])

    def sum(self, col: str) -> Dataset:
        return self._agg([(col, "sum")])

    def mean(self, col: str) -> Dataset:
        return self._agg([(col, "mean")])

    def min(self, col: str) -> Dataset:
        return self._agg([(col, "min")])

    def max(self, col: str) -> Dataset:
        return self._agg([(col, "max")])

    def std(self, col: str, ddof: int = 1) -> Dataset:
        # The grouped stddev defaults to ddof=0 (as pyarrow's); match
        # Dataset.std's sample-std default explicitly.
        return self._agg([(col, "stddev",
                           ("VarianceOptions", {"ddof": ddof}))])

    def map_groups(self, fn, *, batch_format: Optional[str] = None) -> Dataset:
        keys = self._keys

        def ref_fn(refs):
            refs = list(refs)

            @ray_tpu_torch.remote
            def apply(*blocks):
                t = B.concat(list(blocks))
                if not B.num_rows(t):
                    return {}
                outs = []
                # Groups in order of first appearance, rows in input order.
                for rows in _group_rows(t, keys).values():
                    grp = B.take(t, np.asarray(rows))
                    res = fn(B.to_batch(grp, batch_format))
                    outs.append(B.from_batch(res))
                return B.concat(outs)

            return [apply.remote(*refs)]

        return self._ds._with(AllToAllStage("MapGroups", ref_fn))


def _materialized(refs: List[Any]) -> Dataset:
    tasks = [ReadTask(fn=functools.partial(ray_tpu_torch.get, r), name="cached")
             for r in refs]
    return Dataset(tasks)


def from_block_list(blocks: List[B.Block]) -> Dataset:
    refs = [ray_tpu_torch.put(b) for b in blocks]
    return _materialized(refs)
