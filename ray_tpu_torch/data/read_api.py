"""Readers / from_* constructors, counterpart of `ray_tpu/data/read_api.py`
(ref: python/ray/data/read_api.py — read_parquet :604, read_images :775,
from_huggingface :2663; datasource/).

Each reader pre-splits its source into `ReadTask`s (one block each) so the
streaming executor parallelizes and fuses downstream maps into the read.
`read_json`, `read_text`, `read_binary_files`, `read_numpy`,
`read_tfrecords`, `read_webdataset`, `read_sql` and the injected-client
readers need no package beyond numpy; `read_json` gives the columns and
dtypes `pyarrow.json` infers for the same file. `read_parquet`,
`read_csv`, `from_arrow`, `from_pandas`, `from_huggingface` and
`read_images` import their package when they run, and fail without it as
the JAX package does.
"""
from __future__ import annotations

import functools
import glob as globlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data import block as B
from ray_tpu_torch.data.dataset import Dataset, from_block_list
from ray_tpu_torch.data.plan import ReadTask


def _expand_paths(paths, suffixes=None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if suffixes:
        out = [p for p in out
               if any(p.lower().endswith(s) for s in suffixes)]
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def _tasks_from_files(files: List[str], read_one, name: str) -> Dataset:
    return Dataset([ReadTask(functools.partial(read_one, f), name=name)
                    for f in files])


def _columns(cols: Dict[str, List[Any]]) -> B.Block:
    return {k: B.column(v) for k, v in cols.items()}


# ---------------- synthetic ----------------
def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    parallelism = max(1, min(parallelism, n or 1))
    per = -(-n // parallelism) if n else 0

    def make(start, end):
        return lambda: {"id": np.arange(start, end)}

    tasks = []
    i = 0
    while i * per < n:
        tasks.append(ReadTask(make(i * per, min((i + 1) * per, n)),
                              name="range"))
        i += 1
    if not tasks:
        tasks = [ReadTask(lambda: {"id": np.arange(0)}, name="range")]
    return Dataset(tasks)


def range_tensor(n: int, *, shape=(1,), parallelism: int = 8) -> Dataset:
    base = range(n, parallelism=parallelism)

    def expand(batch):
        ids = batch["id"]
        data = np.broadcast_to(ids.reshape((-1,) + (1,) * len(shape)),
                               (len(ids),) + tuple(shape)).copy()
        return {"data": data}

    return base.map_batches(expand, batch_format="numpy")


# ---------------- from_* ----------------
def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    if not items:
        return from_block_list([{}])
    parallelism = max(1, min(parallelism, len(items)))
    per = -(-len(items) // parallelism)
    blocks = [B.from_rows(items[i:i + per])
              for i in __import__("builtins").range(0, len(items), per)]
    return from_block_list(blocks)


def from_numpy(arr, column: str = "data", *, parallelism: int = 1) -> Dataset:
    """One column `column` of `arr`'s rows, or, given a dict of arrays with
    the same number of rows, a column per key; in `parallelism` blocks of
    consecutive rows (one by default, as the JAX package makes)."""
    batch = B.from_batch(arr if isinstance(arr, dict) else {column: arr})
    n = B.num_rows(batch)
    parallelism = max(1, min(parallelism, n or 1))
    edges = np.linspace(0, n, parallelism + 1).astype(np.int64)
    return from_block_list([B.slice_block(batch, int(a), int(b))
                            for a, b in zip(edges[:-1], edges[1:])])


def from_arrow(table) -> Dataset:
    return from_block_list([B.from_arrow(table)])


def from_pandas(df) -> Dataset:
    return from_block_list([B.from_batch(df)])


def from_huggingface(hf_dataset) -> Dataset:
    """HF datasets are Arrow-backed; convert the table directly."""
    t = hf_dataset.data.table if hasattr(hf_dataset, "data") else None
    if t is None:
        return from_block_list([_columns(hf_dataset.to_dict())])
    return from_block_list([B.from_arrow(t.combine_chunks())])


def from_torch(torch_dataset) -> Dataset:
    return from_items([torch_dataset[i]
                       for i in __import__("builtins").range(
                           len(torch_dataset))])


# ---------------- file formats ----------------
def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 **_kw) -> Dataset:
    files = _expand_paths(paths, (".parquet", ".pq"))

    def read_one(f):
        import pyarrow.parquet as pq

        return B.from_arrow(pq.read_table(f, columns=columns))

    return _tasks_from_files(files, read_one, "read_parquet")


def read_csv(paths, **_kw) -> Dataset:
    files = _expand_paths(paths, (".csv",))

    def read_one(f):
        import pyarrow.csv as pcsv

        return B.from_arrow(pcsv.read_csv(f))

    return _tasks_from_files(files, read_one, "read_csv")


def _json_lines(f) -> B.Block:
    """A JSON-lines file as `pyarrow.json.read_json` reads it: one column
    per key in order of first appearance, a row without a key gives null,
    and each column typed as Arrow infers it (`block.column`)."""
    rows = []
    with open(f, encoding="utf-8") as fh:
        for line in fh:
            if line.strip():
                rows.append(json.loads(line))
    keys: List[str] = []
    for r in rows:
        keys += [k for k in r if k not in keys]
    return _columns({k: [r.get(k) for r in rows] for k in keys})


def read_json(paths, **_kw) -> Dataset:
    files = _expand_paths(paths, (".json", ".jsonl"))
    return _tasks_from_files(files, _json_lines, "read_json")


def read_text(paths, **_kw) -> Dataset:
    files = _expand_paths(paths)

    def read_one(f):
        with open(f, encoding="utf-8") as fh:
            lines = [ln.rstrip("\n") for ln in fh]
        return {"text": B.column(lines)}

    return _tasks_from_files(files, read_one, "read_text")


def read_binary_files(paths, *, include_paths: bool = False, **_kw) -> Dataset:
    files = _expand_paths(paths)

    def read_one(f):
        with open(f, "rb") as fh:
            data = fh.read()
        cols = {"bytes": [data]}
        if include_paths:
            cols["path"] = [f]
        return _columns(cols)

    return _tasks_from_files(files, read_one, "read_binary")


def read_images(paths, *, size: Optional[tuple] = None,
                mode: str = "RGB", include_paths: bool = False,
                **_kw) -> Dataset:
    """Decode images into a tensor column (ref: read_api.py:775
    read_images + datasource/image_datasource.py)."""
    files = _expand_paths(paths, (".png", ".jpg", ".jpeg", ".bmp", ".gif",
                                  ".webp"))

    def read_one(f):
        from PIL import Image

        img = Image.open(f).convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        t = B.from_batch({"image": np.asarray(img)[None]})  # (1, H, W, C)
        if include_paths:
            t["path"] = B.column([f])
        return t

    return _tasks_from_files(files, read_one, "read_images")


def read_numpy(paths, **_kw) -> Dataset:
    files = _expand_paths(paths, (".npy",))

    def read_one(f):
        return B.from_batch({"data": np.load(f)})

    return _tasks_from_files(files, read_one, "read_numpy")


def read_tfrecords(paths, **_kw) -> Dataset:
    """TFRecord files of tf.train.Example protos (ref: datasource/
    tfrecords_datasource.py) — decoded by the built-in codec, no
    tensorflow needed."""
    files = _expand_paths(paths, (".tfrecords", ".tfrecord"))

    def read_one(f):
        from ray_tpu_torch.data import tfrecord

        rows = [tfrecord.decode_example(p)
                for p in tfrecord.read_records(f)]
        if not rows:
            return {}
        return B.from_rows(rows)

    return _tasks_from_files(files, read_one, "read_tfrecords")


def read_webdataset(paths, *, decode: bool = True, **_kw) -> Dataset:
    """WebDataset tar shards: members named <key>.<ext> group into one
    sample per key (ref: datasource/webdataset_datasource.py). Known
    extensions decode (json/txt/cls/npy); everything else stays bytes."""
    files = _expand_paths(paths, (".tar",))

    def read_one(f):
        import io
        import json as jsonlib
        import tarfile

        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(f) as tar:
            for member in tar:
                if not member.isfile():
                    continue
                base = os.path.basename(member.name)
                if "." not in base:
                    continue
                key, ext = base.split(".", 1)
                data = tar.extractfile(member).read()
                if decode:
                    if ext == "json":
                        data = jsonlib.loads(data)
                    elif ext in ("txt", "text"):
                        data = data.decode()
                    elif ext == "cls":
                        data = int(data)
                    elif ext == "npy":
                        data = np.load(io.BytesIO(data))
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key][ext] = data
        rows = [samples[k] for k in order]
        if not rows:
            return {}
        # Shards routinely have optional fields: normalize to the union
        # of keys (missing -> None) or column construction KeyErrors.
        all_keys: List[str] = []
        for r in rows:
            for k in r:
                if k not in all_keys:
                    all_keys.append(k)
        rows = [{k: r.get(k) for k in all_keys} for r in rows]
        return B.from_rows(rows)

    return _tasks_from_files(files, read_one, "read_webdataset")


def read_sql(sql: str, connection_factory, **_kw) -> Dataset:
    """Run a query through a DBAPI connection factory (ref: datasource/
    sql_datasource.py — e.g. `lambda: sqlite3.connect(path)`). The query
    executes inside one read task on the cluster (arbitrary SQL cannot
    be partitioned generically; shard by issuing multiple queries)."""

    def read_one(_unused=None):
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        return _columns({c: [r[i] for r in rows] for i, c in enumerate(cols)})

    return Dataset([ReadTask(read_one, name="read_sql")])


def read_mongo(uri: Optional[str] = None, database: Optional[str] = None,
               collection: Optional[str] = None, *,
               pipeline: Optional[List[dict]] = None,
               pipelines: Optional[List[List[dict]]] = None,
               client_factory=None, **_kw) -> Dataset:
    """Read a MongoDB collection (ref: datasource/mongo_datasource.py).

    Positional shape matches the reference: (uri, database, collection).
    `client_factory` is the injectable seam: any callable returning a
    pymongo.MongoClient-compatible object — tests inject a fake,
    production omits it and pymongo connects to `uri`. Pass `pipelines`
    (a list of aggregation pipelines) to shard the read into one task per
    pipeline; `pipeline` alone reads in one task."""
    if not database or not collection:
        raise ValueError("read_mongo needs `database` and `collection`")
    if client_factory is None:
        def client_factory():  # pragma: no cover - needs a live mongod
            try:
                import pymongo
            except ImportError as e:
                raise ImportError(
                    "read_mongo needs `pymongo` (or pass "
                    "client_factory=)") from e
            return pymongo.MongoClient(uri)

    shards = pipelines if pipelines is not None else [pipeline or []]

    def make_read(shard_pipeline):
        def read_one(_unused=None):
            client = client_factory()
            try:
                coll = client[database][collection]
                rows = [dict(doc) for doc in
                        (coll.aggregate(shard_pipeline)
                         if shard_pipeline else coll.find())]
            finally:
                try:
                    client.close()
                except Exception:  # noqa: BLE001
                    pass
            for r in rows:
                r.pop("_id", None)   # ObjectId is not a column value
            if not rows:
                return {}
            return B.from_rows(rows)

        return read_one

    return Dataset([ReadTask(make_read(p), name="read_mongo")
                    for p in shards])


def read_bigquery(project_id: Optional[str] = None, *,
                  dataset: Optional[str] = None,
                  query: Optional[str] = None,
                  client_factory=None, **_kw) -> Dataset:
    """Read a BigQuery table or query result (ref: datasource/
    bigquery_datasource.py — same (project_id, dataset=, query=) shape
    as the reference's read_bigquery). `client_factory` returns a
    google.cloud.bigquery.Client-compatible object (tests inject a
    fake); `dataset` is "dataset.table" when `query` is None."""
    if query is None:
        if not dataset:
            raise ValueError("read_bigquery needs `query` or `dataset`")
        query = f"SELECT * FROM `{dataset}`"

    if client_factory is None:
        def client_factory():  # pragma: no cover - needs GCP creds
            try:
                from google.cloud import bigquery
            except ImportError as e:
                raise ImportError(
                    "read_bigquery needs `google-cloud-bigquery` (or "
                    "pass client_factory=)") from e
            return bigquery.Client(project=project_id)

    def read_one(_unused=None):
        client = client_factory()
        result = client.query(query).result()
        to_arrow = getattr(result, "to_arrow", None)
        if to_arrow is not None:
            return B.from_arrow(to_arrow())
        rows = [dict(r.items()) if hasattr(r, "items") else dict(r)
                for r in result]
        if not rows:
            return {}
        return B.from_rows(rows)

    return Dataset([ReadTask(read_one, name="read_bigquery")])
