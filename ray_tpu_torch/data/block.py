"""Block model, counterpart of `ray_tpu/data/block.py`.

A Dataset is a list of blocks in the object store. In the JAX package a
block is a `pyarrow.Table`; here it is an ordered mapping of column name to
an ndarray whose first axis is the rows. The reason is the card's machine:
it has no pyarrow and no pandas, and the data layer must run there. So:

- a numeric column is an ndarray of its dtype; a tensor column stays an N-D
  array (the JAX package flattens it into a fixed-size list column with its
  shape in the schema metadata);
- strings, bytes and other Python values are object arrays. A numeric
  column with missing values (None) is an object array too, so the
  aggregates can skip nulls as Arrow's do; `to_numpy` hands it out as
  float64 with NaN in their place, as Arrow's `to_numpy` does;
- blocks travel through the store as pickled ndarrays, whose buffers are
  out of band: a reader maps them without a copy (and gets read-only views).

`batch_format="pandas"` and `"pyarrow"` convert on request and import their
package only then.
"""
from __future__ import annotations

import dataclasses
import json
import numbers
import pickle
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]

# The JAX package's tensor-shape metadata key, read and written by the Arrow
# conversions so that tables round-trip between the two packages.
TENSOR_META_KEY = b"rtpu_tensor_shape"


@dataclasses.dataclass(frozen=True)
class Schema:
    """Column names, dtypes and per-row tensor shapes (() for a scalar)."""
    names: List[str]
    types: List[np.dtype]
    shapes: List[tuple]


def _objects(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values) if not isinstance(values, list) else values
    return out


def _is_number(v) -> bool:
    return isinstance(v, numbers.Number) and not isinstance(v, (bool, np.bool_))


def column(values: List[Any]) -> np.ndarray:
    """A column from Python values, with the types Arrow infers for them:
    ints -> int64, floats (or ints and floats) -> float64, bools -> bool,
    equal-length lists or arrays of numbers -> an N-D array, anything else
    (strings, bytes, dicts, None) -> an object array. Numbers with None
    stay an object array (nullable)."""
    n = len(values)
    if n == 0:
        return np.empty(0, dtype=object)
    present = [v for v in values if v is not None]
    if len(present) < n or not present:
        return _objects(values)
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        return np.asarray(values, dtype=bool)
    if all(_is_number(v) for v in present):
        if all(isinstance(v, (numbers.Integral)) for v in present):
            return np.asarray(values, dtype=np.int64)
        if all(isinstance(v, (numbers.Real)) for v in present):
            return np.asarray(values, dtype=np.float64)
        return _objects(values)
    if all(isinstance(v, (list, tuple, np.ndarray)) for v in present):
        arrays = [np.asarray(v) for v in values]
        shape = arrays[0].shape
        if (all(a.shape == shape and a.dtype.kind in "biuf" for a in arrays)
                and len(shape) >= 1):
            kinds = {a.dtype.kind for a in arrays}
            if all(isinstance(v, np.ndarray) for v in values):
                return np.stack(arrays)
            dtype = (bool if kinds == {"b"} else np.float64 if "f" in kinds
                     else np.int64)
            return np.stack(arrays).astype(dtype, copy=False)
    return _objects(values)


def _as_column(v) -> np.ndarray:
    """A UDF's column: an ndarray, with text and bytes as object arrays."""
    if isinstance(v, np.ndarray) and v.dtype.kind not in "US":
        return v
    if isinstance(v, (list, tuple)) and not isinstance(v, np.ndarray):
        arr = np.asarray(v) if v and not any(x is None for x in v) else None
        if arr is None or arr.dtype == object:
            return column(list(v))
        v = arr
    else:
        v = np.asarray(v)
    return v.astype(object) if v.dtype.kind in "US" else v


def from_batch(batch: Any) -> Block:
    """Build a block from a UDF return: dict of arrays, pandas, or a table."""
    if isinstance(batch, dict):
        out = {str(k): _as_column(v) for k, v in batch.items()}
        if len({len(v) for v in out.values()}) > 1:
            raise ValueError("a block's columns must have the same number of rows: "
                             + str({k: len(v) for k, v in out.items()}))
        return out
    kind = type(batch).__module__.split(".")[0]
    if kind == "pandas":
        return {str(c): _as_column(batch[c].to_numpy()) for c in batch.columns}
    if kind == "pyarrow":
        return from_arrow(batch)
    raise TypeError(f"cannot build a block from {type(batch).__name__}")


def from_rows(rows: List[Any]) -> Block:
    """Items -> one 'item' column, or a column per key for dicts."""
    if rows and isinstance(rows[0], dict):
        keys = list(rows[0].keys())
        return {k: column([r[k] for r in rows]) for k in keys}
    return {"item": column(list(rows))}


def _tensor_shapes(meta: Optional[dict]) -> Dict[str, tuple]:
    # The metadata may come from an external file: strict JSON only.
    raw = (meta or {}).get(TENSOR_META_KEY)
    if not raw:
        return {}
    try:
        d = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return {}
    out = {}
    for k, v in (d.items() if isinstance(d, dict) else ()):
        try:
            out[str(k).rsplit(".shape", 1)[0]] = tuple(int(x) for x in str(v).split(","))
        except ValueError:
            continue
    return out


def from_arrow(table) -> Block:
    """A pyarrow Table -> a block (fixed-size list columns to N-D arrays,
    by the JAX package's tensor metadata; nulls kept as None)."""
    import pyarrow as pa

    shapes = _tensor_shapes(table.schema.metadata)
    out = {}
    n = table.num_rows
    for name in table.column_names:
        col = table.column(name)
        if pa.types.is_fixed_size_list(col.type) and not col.null_count:
            flat = col.combine_chunks().flatten().to_numpy(zero_copy_only=False)
            arr = flat.reshape(n, col.type.list_size)
            out[name] = arr.reshape((n,) + shapes[name]) if name in shapes else arr
        elif (col.null_count or pa.types.is_list(col.type)
              or pa.types.is_large_list(col.type) or pa.types.is_null(col.type)
              or pa.types.is_fixed_size_list(col.type)):
            out[name] = column(col.to_pylist())
        else:
            out[name] = _as_column(col.to_numpy(zero_copy_only=False))
    return out


def to_arrow(block: Block):
    """A block -> a pyarrow Table, laid out as the JAX package's blocks."""
    import pyarrow as pa

    cols, meta = {}, {}
    for k, v in block.items():
        if v.ndim > 1:
            flat = v.reshape(len(v), -1)
            cols[k] = pa.FixedSizeListArray.from_arrays(pa.array(flat.ravel()),
                                                        flat.shape[1])
            meta[f"{k}.shape"] = ",".join(map(str, v.shape[1:]))
        else:
            cols[k] = pa.array(v.tolist() if v.dtype == object else v)
    t = pa.table(cols)
    if meta:
        t = t.replace_schema_metadata({TENSOR_META_KEY: json.dumps(meta).encode()})
    return t


def _nullable_numbers(v: np.ndarray) -> bool:
    """An object column of numbers and None (a nullable numeric column)."""
    return (v.dtype == object and v.ndim == 1
            and any(x is not None for x in v)
            and all(x is None or _is_number(x) for x in v))


def to_numpy(block: Block) -> Dict[str, np.ndarray]:
    """The numpy batch of a block. A nullable numeric column comes out as
    Arrow's `to_numpy` gives it: float64 with NaN where rows are null, and
    its own int64 or float64 where none is."""
    out = {}
    for k, v in block.items():
        if _nullable_numbers(v):
            v = (np.array([np.nan if x is None else x for x in v], dtype=np.float64)
                 if any(x is None for x in v) else column(v.tolist()))
        out[k] = v
    return out


def to_pandas(block: Block):
    import pandas as pd

    return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                         for k, v in to_numpy(block).items()})


def to_batch(block: Block, batch_format: Optional[str]):
    if batch_format in (None, "numpy", "np"):
        return to_numpy(block)
    if batch_format in ("pandas", "pd"):
        return to_pandas(block)
    if batch_format in ("pyarrow", "arrow"):
        return to_arrow(block)
    raise ValueError(f"unknown batch_format {batch_format!r}")


def iter_rows(block: Block) -> Iterator[Any]:
    cols = to_numpy(block)
    names = list(cols)
    for i in range(num_rows(block)):
        row = {k: cols[k][i] for k in names}
        yield row["item"] if names == ["item"] else row


def slice_block(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def take(block: Block, idx: np.ndarray) -> Block:
    """Rows `idx` of the block, in that order (Arrow's `take`)."""
    return {k: v[idx] for k, v in block.items()}


def concat(blocks: List[Block]) -> Block:
    """Concatenate blocks' rows. Columns are the union of theirs, in order
    of appearance, and a block without a column gives it None (Arrow fills
    nulls). Two different non-object dtypes or tensor shapes raise, as
    Arrow's `promote_options="default"` does."""
    blocks = [b for b in blocks if b is not None and num_rows(b) > 0]
    if not blocks:
        return {}
    if len(blocks) == 1:
        return dict(blocks[0])
    names: List[str] = []
    for b in blocks:
        names += [k for k in b if k not in names]
    out = {}
    for k in names:
        parts = [b[k] if k in b else np.full(num_rows(b), None, dtype=object)
                 for b in blocks]
        kinds = {(p.dtype, p.shape[1:]) for p in parts if p.dtype != object}
        if len(kinds) > 1:
            raise TypeError(f"cannot concatenate column {k!r}: incompatible "
                            f"types {sorted(str(d) + str(s) for d, s in kinds)}")
        if any(p.dtype == object for p in parts):
            if any(p.ndim > 1 for p in parts):
                raise TypeError(f"cannot concatenate column {k!r}: a tensor "
                                "column with missing rows")
            parts = [p.astype(object) for p in parts]
        out[k] = np.concatenate(parts)
    return out


def batches(block: Block, batch_size: Optional[int]) -> Iterator[Block]:
    n = num_rows(block)
    if batch_size is None or batch_size >= n:
        if n:
            yield block
        return
    for s in range(0, n, batch_size):
        yield slice_block(block, s, s + batch_size)


def size_bytes(block: Block) -> int:
    """The arrays' buffers; an object column counts as it is pickled."""
    return sum(len(pickle.dumps(v, protocol=5)) if v.dtype == object else v.nbytes
               for v in block.values())


def num_rows(block: Block) -> int:
    for v in block.values():
        return len(v)
    return 0


def schema(block: Block) -> Schema:
    return Schema(list(block), [v.dtype for v in block.values()],
                  [tuple(v.shape[1:]) for v in block.values()])
