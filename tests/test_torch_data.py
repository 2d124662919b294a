"""ray_tpu_torch.data against ray_tpu.data, on the CPU.

Each runtime starts one single-host cluster for this file
(`init(num_cpus=4)`) and shuts it down in `finally`, never both at once.
The same scenarios run through both data layers on the same seeded numpy
inputs: JAX's run records what it got, the port's run is held to the
record. Rows and batches must be equal exactly, dtypes included (a numpy
value keeps its dtype in the record); float aggregates within 1e-12
relative. The scenarios are those of tests/test_data.py,
tests/test_data_breadth.py and tests/test_data_operator_graph.py, plus what
the port's numpy blocks must get right where JAX's are Arrow tables: the
block functions themselves, `read_json`'s types, nulls, NaN, one-row std,
quantile interpolation, zero-row blocks and empty datasets, and the device
feed (`iter_device_batches` on the CPU; `device="cuda"` raises here).

One difference is by design: a list column (equal-length lists of
numbers) is an N-D array in the port and an object array of arrays in
JAX's batches; the record stacks JAX's before comparing.
"""
import io
import json
import math
import sqlite3
import tarfile
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

RECORD = {}   # scenario -> what the JAX package's data layer gave
AGG_REL = 1e-12


@pytest.fixture(scope="module", params=[ray_tpu, ray_tpu_torch],
                ids=["ray_tpu", "ray_tpu_torch"])
def rt(request):
    rt = request.param
    for other in (ray_tpu, ray_tpu_torch):
        if other.is_initialized():
            other.shutdown()
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def canon(x):
    """A value with its numpy dtype kept, for exact comparison: arrays as
    (dtype, shape, values); JAX's object arrays of equal-shape numeric
    arrays (its list columns) stacked first."""
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, np.ndarray):
        if (x.dtype == object and len(x)
                and all(isinstance(v, np.ndarray) and v.dtype != object
                        for v in x)
                and len({v.shape for v in x}) == 1):
            x = np.stack(list(x))
        if x.dtype == object:
            return ("object", x.shape, [canon(v) for v in x.tolist()])
        return (x.dtype.str, x.shape, canon(x.tolist()) if x.dtype.kind in "fc"
                else x.tolist())
    if isinstance(x, np.generic):
        return (x.dtype.str, canon(x.item()))
    if isinstance(x, float) and math.isnan(x):
        return ("nan",)
    return x


def agree(name, rt, got, rel=None):
    """Record JAX's result; hold the port's to it (exactly, or within
    `rel` for floats)."""
    got = canon(got)
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        want = RECORD[name]
        if rel is None:
            assert got == want, (name, got, want)
        else:
            _close(got, want, rel, name)
    return got


def _close(got, want, rel, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, got, want)
        for k in want:
            _close(got[k], want[k], rel, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rel, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float) and got == pytest.approx(want, rel=rel), \
            (where, got, want)
    else:
        assert got == want, (where, got, want)


# -- the block model on its own (no cluster) ---------------------------------

BLOCK_CASES = {
    "ints_floats_strings": [{"a": i, "v": i * 0.5, "s": f"s{i}", "b": i % 2 == 0}
                            for i in range(5)],
    "nulls": [{"v": None, "i": 1}, {"v": 2.5, "i": None}, {"v": 1.0, "i": 3}],
    "all_null": [{"v": None}, {"v": None}],
    "lists": [{"vec": [float(i), 1.0], "ids": [i, i + 1]} for i in range(4)],
    "bytes_dicts": [{"b": b"x%d" % i, "d": {"k": i}} for i in range(3)],
    "items": list(range(6)),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_functions_match_jax(case):
    """from_rows, to_numpy, iter_rows, slice, batches, concat and the Arrow
    round trip give JAX's batches and rows for the same items."""
    from ray_tpu.data import block as JB
    from ray_tpu_torch.data import block as TB

    items = BLOCK_CASES[case]
    jb, tb = JB.from_rows(items), TB.from_rows(items)
    assert canon(TB.to_numpy(tb)) == canon(JB.to_numpy(jb))
    assert canon(list(TB.iter_rows(tb))) == canon(list(JB.iter_rows(jb)))
    assert TB.num_rows(tb) == JB.num_rows(jb) == len(items)
    assert canon(TB.to_numpy(TB.slice_block(tb, 1, 3))) == \
        canon(JB.to_numpy(JB.slice_block(jb, 1, 3)))
    assert [TB.num_rows(b) for b in TB.batches(tb, 2)] == \
        [b.num_rows for b in JB.batches(jb, 2)]
    both = TB.concat([tb, TB.slice_block(tb, 0, 0), tb])
    assert canon(TB.to_numpy(both)) == canon(JB.to_numpy(JB.concat([jb, jb.slice(0, 0), jb])))
    assert canon(TB.to_numpy(TB.from_arrow(jb))) == canon(JB.to_numpy(jb))
    assert canon(TB.to_numpy(TB.from_arrow(TB.to_arrow(tb)))) == canon(TB.to_numpy(tb))


def test_block_concat_promotes_as_arrow():
    """Zero-row blocks and no blocks, missing columns (filled with null),
    null columns promoted, and incompatible types refused, as
    `pa.concat_tables(promote_options="default")` does."""
    import pyarrow as pa

    from ray_tpu.data import block as JB
    from ray_tpu_torch.data import block as TB

    assert TB.concat([]) == {} and JB.concat([]).num_rows == 0
    assert TB.num_rows(TB.concat([{"x": np.arange(0)}])) == 0
    got = TB.to_numpy(TB.concat([{"x": np.arange(2)}, {"y": np.arange(1)}]))
    want = JB.to_numpy(JB.concat([pa.table({"x": np.arange(2)}), pa.table({"y": np.arange(1)})]))
    assert canon(got) == canon(want)
    got = TB.to_numpy(TB.concat([TB.from_rows([{"v": None}]), {"v": np.array([1.5])}]))
    want = JB.to_numpy(JB.concat([pa.table({"v": [None]}), pa.table({"v": [1.5]})]))
    assert canon(got) == canon(want)
    with pytest.raises(TypeError):
        TB.concat([{"x": np.arange(2, dtype=np.int32)}, {"x": np.arange(2)}])
    with pytest.raises(pa.ArrowTypeError):
        JB.concat([pa.table({"x": np.arange(2, dtype=np.int32)}), pa.table({"x": np.arange(2)})])


def test_block_tensor_column_stays_nd():
    """A tensor column is an N-D array in the block (no flattening), its
    batch equals JAX's, and size_bytes counts buffers (objects pickled)."""
    from ray_tpu.data import block as JB
    from ray_tpu_torch.data import block as TB

    arr = np.arange(24.0).reshape(6, 2, 2)
    tb = TB.from_batch({"data": arr, "s": np.array(["a", "b", "c", "d", "e", "f"])})
    assert tb["data"].shape == (6, 2, 2) and tb["s"].dtype == object
    jb = JB.from_batch({"data": arr, "s": np.array(["a", "b", "c", "d", "e", "f"])})
    assert canon(TB.to_numpy(tb)) == canon(JB.to_numpy(jb))
    assert TB.size_bytes({"data": arr}) == arr.nbytes
    assert TB.schema(tb).shapes == [(2, 2), ()]
    assert TB.to_batch(tb, "pandas").shape == (6, 2)
    assert canon(TB.to_numpy(TB.from_batch(TB.to_batch(tb, "pyarrow")))) == canon(TB.to_numpy(tb))


# -- the scenarios of tests/test_data.py -------------------------------------

def test_range_count_take(rt):
    ds = rt.data.range(100, parallelism=4)
    agree("range", rt, (ds.count(), ds.take(5)))


def test_map_batches_fused_pipeline(rt):
    ds = (rt.data.range(64, parallelism=4)
          .map_batches(lambda b: {"x": b["id"] * 2}, batch_format="numpy")
          .map_batches(lambda b: {"x": b["x"] + 1}, batch_format="numpy"))
    agree("fused", rt, ds.to_numpy())


def test_map_filter_flatmap(rt):
    ds = rt.data.from_items(list(range(10)))
    agree("map_filter_flat", rt, (
        ds.map(lambda x: x * 10).take_all(), ds.filter(lambda x: x % 2 == 0).take_all(),
        ds.flat_map(lambda x: [x, x]).take_all(),
        ds.filter(lambda x: x > 100).take_all(), ds.filter(lambda x: x > 100).count()))


def test_actor_pool_map_batches(rt):
    class AddConst:
        def __init__(self, c=100):
            self.c = c

        def __call__(self, batch):
            return {"id": batch["id"] + self.c}

    ds = rt.data.range(32, parallelism=4).map_batches(
        AddConst, concurrency=2, fn_constructor_args=(100,), batch_format="numpy")
    agree("actor_pool", rt, ds.to_numpy())


def test_limit_streaming_and_order(rt):
    ds = rt.data.range(1000, parallelism=10).limit(17)
    agree("limit", rt, (ds.count(), ds.take_all()))


def test_repartition_and_num_blocks(rt):
    ds = rt.data.range(100, parallelism=2).repartition(5)
    agree("repartition", rt, (ds.num_blocks(), ds.count(), ds.take_all()))


def test_random_shuffle_gives_jax_order(rt):
    """A seeded shuffle gives JAX's row order: the same RNG calls in the
    same order over the same blocks, on the streaming path and the legacy
    one (`data_stream_enabled=0`)."""
    cfg = importlib_config(rt)
    order = {}
    try:
        for streaming in (True, False):
            cfg.data_stream_enabled = streaming
            ds = rt.data.range(200, parallelism=4).random_shuffle(seed=0)
            order[streaming] = [r["id"] for r in ds.take_all()]
    finally:
        cfg.data_stream_enabled = True
    assert sorted(order[True]) == list(range(200)) != order[True]
    agree("shuffle_order", rt, order)


def importlib_config(rt):
    import importlib

    return importlib.import_module(f"{rt.__name__}.core.config").get_config()


def test_sort_and_aggregates(rt):
    ds = rt.data.from_items([{"a": i % 5, "v": float(i)} for i in range(50)])
    agree("sort_aggs", rt, (ds.sort("v", descending=True).take(3),
                            ds.sum("v"), ds.min("v"), ds.max("v"), ds.mean("v"),
                            ds.sum("a"), ds.min("a")))


def test_sort_with_empty_key_ranges(rt):
    """Sorting 8 blocks on a key of 5 values leaves some key ranges empty.
    JAX's merge then sorts a table with no columns and fails
    (`ray_tpu/data/dataset.py:313`); the port gives the stable sort."""
    items = [{"a": i % 5, "v": float(i)} for i in range(50)]
    ds = rt.data.from_items(items)
    if rt is ray_tpu:
        with pytest.raises(Exception, match="sort key"):
            ds.sort("a").take_all()
        return
    for desc in (False, True):
        want = sorted(items, key=lambda r: r["a"], reverse=desc)   # stable
        got = [{k: v.item() for k, v in r.items()} for r in ds.sort("a", desc).take_all()]
        assert got == want


def test_groupby_agg_and_map_groups(rt):
    ds = rt.data.from_items([{"k": i % 3, "v": i} for i in range(12)])
    mg = ds.groupby("k").map_groups(
        lambda b: {"k": b["k"][:1], "n": np.array([len(b["v"])])},
        batch_format="numpy")
    agree("groupby", rt, (ds.groupby("k").sum("v").take_all(), mg.take_all(),
                          ds.groupby("k").count().take_all(),
                          ds.groupby("k").min("v").take_all(),
                          ds.groupby("k").max("v").take_all(),
                          ds.groupby("k").mean("v").take_all()))


def test_split_and_train_test_split(rt):
    parts = rt.data.range(100, parallelism=4).split(4)
    tr, te = rt.data.range(100).train_test_split(0.2)
    eq = rt.data.range(10, parallelism=3).split(3, equal=True)
    agree("split", rt, ([p.take_all() for p in parts], tr.take_all(), te.take_all(),
                        [p.take_all() for p in eq],
                        [p.count() for p in rt.data.range(10).split_at_indices([2, 7])]))


def test_union_zip_add_column(rt):
    a, b = rt.data.range(10), rt.data.range(10)
    z = a.zip(rt.data.range(10).map_batches(lambda t: {"other": t["id"] * 2},
                                            batch_format="numpy"))
    wc = a.add_column("double", lambda b: b["id"] * 2)
    zz = a.zip(rt.data.range(7))
    agree("union_zip", rt, (a.union(b).take_all(), z.take_all(), wc.take_all(),
                            zz.take_all()))


def test_tensor_columns_roundtrip(rt):
    arr = np.arange(24.0).reshape(6, 2, 2)
    ds = rt.data.from_numpy(arr)
    out = ds.map_batches(lambda b: {"data": b["data"] * 2}, batch_format="numpy")
    agree("tensor", rt, (out.to_numpy(), out.take(2)))


def test_iter_batches_sizes(rt):
    ds = rt.data.range(25, parallelism=3)
    agree("iter_batches", rt, (
        list(ds.iter_batches(batch_size=10, batch_format="numpy")),
        list(ds.iter_batches(batch_size=10, batch_format="numpy", drop_last=True))))


def test_column_transforms(rt):
    ds = rt.data.from_items([{"a": i, "b": float(i), "c": str(i)} for i in range(6)])
    agree("columns", rt, (
        ds.select_columns(["c", "a"]).take_all(), ds.drop_columns(["b"]).take_all(),
        ds.rename_columns({"a": "x"}).take_all(), ds.columns()))


def test_random_sample(rt):
    """JAX's random_sample digests `block.column(0).combine_chunks()
    .chunk(0)`, which pyarrow 25's Array lacks, so it fails
    (`ray_tpu/data/dataset.py:360`); the port's draws a seeded mask."""
    ds = rt.data.range(400, parallelism=4)
    if rt is ray_tpu:
        with pytest.raises(Exception, match="chunk"):
            ds.random_sample(0.5, seed=3).count()
        return
    a = [r["id"] for r in ds.random_sample(0.5, seed=3).take_all()]
    assert a == [r["id"] for r in ds.random_sample(0.5, seed=3).take_all()]
    assert 120 < len(a) < 280 and a == sorted(set(a))


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json"])
def test_file_io_roundtrip(rt, tmp_path, fmt):
    ds = rt.data.from_items([{"x": i, "y": str(i), "z": i * 0.25} for i in range(30)],
                            parallelism=3)
    path = str(tmp_path / fmt)
    getattr(ds, f"write_{fmt}")(path)
    back = getattr(rt.data, f"read_{fmt}")(path)
    agree(f"io_{fmt}", rt, (back.count(), sorted(back.take_all(), key=lambda r: r["x"])))


def test_read_text_and_binary(rt, tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("hello\nworld\n")
    b = rt.data.read_binary_files(str(p), include_paths=True).take_all()[0]
    assert b["path"] == str(p)
    agree("text_binary", rt, (rt.data.read_text(str(p)).take_all(), b["bytes"]))


def test_device_batches_on_the_cpu(rt):
    """The counterpart of iter_jax_batches: batches on the CPU device with
    `device="cpu"`, the values of JAX's device arrays; `device="cuda"`
    raises without a card, as torch_feed does."""
    import torch

    ds = rt.data.range(32).map_batches(
        lambda b: {"x": b["id"].astype(np.float32)}, batch_format="numpy")
    if rt is ray_tpu:
        got = [{k: np.asarray(v) for k, v in b.items()}
               for b in ds.iter_jax_batches(batch_size=8)]
    else:
        with ds.iter_device_batches(batch_size=8, device="cpu") as feed:
            batches = list(feed)
        assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
                   for b in batches)
        got = [{k: v.numpy() for k, v in b.items()} for b in batches]
        assert feed.hits + feed.misses == 5
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                ds.iter_device_batches(batch_size=8)
    agree("device_batches", rt, got)


def test_iter_torch_batches_copies_read_only_views(rt):
    ds = rt.data.range(16, parallelism=2)
    batches = list(ds.iter_torch_batches(batch_size=8))
    for b in batches:
        b["id"].add_(1)   # writable: the store's read-only views were copied
    agree("torch_batches", rt, [b["id"].tolist() for b in batches])


def test_from_pandas_arrow_hf(rt):
    import pandas as pd
    import pyarrow as pa

    df = pd.DataFrame({"a": [1, 2, 3], "s": ["x", "y", "z"]})
    agree("pandas_arrow", rt, (rt.data.from_pandas(df).take_all(),
                               rt.data.from_arrow(pa.table({"a": [1, 2]})).take_all(),
                               rt.data.from_pandas(df).to_pandas().equals(df),
                               rt.data.from_items([{"a": 1}]).to_arrow().column_names))


def test_distributed_sort_range_partitions(rt):
    rng = np.random.default_rng(7)
    vals = rng.permutation(2000).astype(float)
    ds = rt.data.from_items([{"v": float(v)} for v in vals], parallelism=8)
    out = ds.sort("v")
    refs = list(out.to_block_refs())
    assert len(refs) == 8
    blocks = rt.get(refs)
    if rt is ray_tpu:
        sizes, got = [b.num_rows for b in blocks], [b.column("v").to_numpy() for b in blocks]
    else:
        sizes, got = [len(b["v"]) for b in blocks], [b["v"] for b in blocks]
    np.testing.assert_array_equal(np.concatenate(got), np.sort(vals))
    agree("range_sort", rt, (sizes, [r["v"] for r in ds.sort("v", descending=True).take_all()]))


def test_distributed_sort_string_keys_and_ties(rt):
    words = [f"w{i:04d}" for i in range(300)]
    rng = np.random.default_rng(3)
    shuffled = list(words)
    rng.shuffle(shuffled)
    ds = rt.data.from_items([{"s": w, "i": i} for i, w in enumerate(shuffled)],
                            parallelism=6)
    ties = rt.data.from_items([{"k": i % 4, "i": i} for i in range(40)], parallelism=1)
    nan = rt.data.from_items([{"v": v, "i": i} for i, v in
                              enumerate([3.0, float("nan"), None, 1.0, 3.0, 2.0])],
                             parallelism=1)
    agree("string_sort", rt, (
        [r["s"] for r in ds.sort("s").take_all()],
        [r["i"] for r in ties.sort("k").take_all()],
        [r["i"] for r in ties.sort("k", descending=True).take_all()],
        [r["i"] for r in nan.sort("v").take_all()],
        [r["i"] for r in nan.sort("v", descending=True).take_all()]))


def test_streaming_split_consumes_once_disjoint(rt):
    its = rt.data.range(400, parallelism=8).streaming_split(4)
    seen = [sorted(r["id"] for r in it.iter_rows()) for it in its]
    agree("ssplit", rt, (sorted(x for part in seen for x in part), sum(len(p) for p in seen)))


def test_streaming_split_equal_round_robin(rt):
    its = rt.data.range(320, parallelism=8).streaming_split(4, equal=True)
    counts = [sum(1 for _ in it.iter_rows()) for it in its]
    assert max(counts) - min(counts) <= 40
    agree("ssplit_equal", rt, counts)


def test_streaming_split_one_consumer_keeps_order(rt):
    """One consumer of streaming_split(equal=False) sees the rows in order,
    through fused map stages."""
    ds = rt.data.range(100, parallelism=10).map_batches(
        lambda b: {"id": b["id"] * 3}, batch_format="numpy")
    (it,) = ds.streaming_split(1)
    agree("ssplit_order", rt, [r["id"] for r in it.iter_rows()])


def test_streaming_split_feeds_parallel_consumers(rt):
    its = rt.data.range(256, parallelism=8).streaming_split(4)

    @rt.remote
    def consume(it):
        total = 0
        for batch in it.iter_torch_batches(batch_size=32):
            total += int(batch["id"].sum())
        return total

    totals = rt.get([consume.remote(it) for it in its], timeout=120)
    agree("ssplit_parallel", rt, sum(totals))


# -- the scenarios of tests/test_data_breadth.py ------------------------------

def test_tfrecord_codec_matches_jax(tmp_path):
    """The port's codec writes JAX's bytes and reads them back; a flipped
    payload byte fails its crc."""
    from ray_tpu.data import tfrecord as jt
    from ray_tpu_torch.data import tfrecord as tt

    rows = [{"name": b"alpha", "score": 1.5, "count": 7},
            {"name": b"beta", "score": -2.25, "count": -3,
             "vec": [1.0, 2.0, 3.0], "ids": [1, 2, 3]}]
    for mod, name in ((jt, "j"), (tt, "t")):
        mod.write_records(str(tmp_path / name), (mod.encode_example(r) for r in rows))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    out = [tt.decode_example(p) for p in tt.read_records(str(tmp_path / "j"))]
    assert out == [jt.decode_example(p) for p in jt.read_records(str(tmp_path / "t"))]
    raw = bytearray((tmp_path / "t").read_bytes())
    raw[-5] ^= 0xFF
    (tmp_path / "t").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc"):
        list(tt.read_records(str(tmp_path / "t")))


def test_read_write_tfrecords(rt, tmp_path):
    ds = rt.data.from_items([{"x": i, "y": float(i) * 0.5} for i in range(20)], parallelism=3)
    ds.write_tfrecords(str(tmp_path / "tfr"))
    agree("tfrecords", rt, sorted(rt.data.read_tfrecords(str(tmp_path / "tfr")).take_all(),
                                  key=lambda r: r["x"]))


def test_read_webdataset(rt, tmp_path):
    shard = str(tmp_path / "shard-000.tar")
    with tarfile.open(shard, "w") as tar:
        for i in range(5):
            members = [("json", json.dumps({"i": i}).encode()),
                       ("txt", f"caption {i}".encode()), ("cls", str(i % 2).encode())]
            if i % 2:
                buf = io.BytesIO()
                np.save(buf, np.arange(3) * i)
                members.append(("npy", buf.getvalue()))
            for ext, payload in members:
                info = tarfile.TarInfo(name=f"sample{i:04d}.{ext}")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
    rows = sorted(rt.data.read_webdataset(shard).take_all(), key=lambda r: r["__key__"])
    agree("webdataset", rt, rows)


def test_read_sql(rt, tmp_path):
    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE pts (x INTEGER, label TEXT, w REAL)")
    conn.executemany("INSERT INTO pts VALUES (?, ?, ?)",
                     [(i, f"l{i}", None if i == 3 else i / 4) for i in range(10)])
    conn.commit()
    conn.close()
    ds = rt.data.read_sql("SELECT x, label, w FROM pts WHERE x < 5",
                          lambda: sqlite3.connect(db))
    none = rt.data.read_sql("SELECT x FROM pts WHERE x < 0", lambda: sqlite3.connect(db))
    agree("sql", rt, (sorted(ds.take_all(), key=lambda r: r["x"]), ds.sum("w"),
                      none.count()))


def test_gated_sources_raise_helpfully(rt):
    with pytest.raises(Exception, match="pymongo"):
        rt.data.read_mongo("mongodb://x", database="db", collection="coll").take_all()
    with pytest.raises(Exception, match="bigquery"):
        rt.data.read_bigquery(dataset="project.table").take_all()


def test_dataset_stats(rt):
    ds = rt.data.range(1000, parallelism=4).map_batches(
        lambda b: {"id": b["id"] * 2}, batch_format="numpy")
    assert "not been executed" in ds.stats()
    assert ds.count() == 1000
    s = ds.stats()
    assert "consumed: 1000 rows" in s and "4 tasks" in s
    agree("stats", rt, [(st.name, st.tasks, st.rows_out) for st in ds._last_stats.stages])


def test_backpressure_window_shrinks_under_store_pressure(rt, monkeypatch):
    import importlib

    execution = importlib.import_module(f"{rt.__name__}.data.execution")
    api = importlib.import_module(f"{rt.__name__}.api")

    class FakeStore:
        capacity = 100
        used = 90

    class FakeWorker:
        store = FakeStore()

    monkeypatch.setattr(api, "_worker", FakeWorker())
    shrunk = execution._effective_window(32)
    FakeStore.used = 10
    agree("window", rt, (shrunk, execution._effective_window(32)))


def test_aggregate_depth_std_quantile_unique(rt):
    vals = np.arange(100, dtype=np.float64)
    ds = rt.data.from_items([{"v": float(v), "g": int(v) % 3} for v in vals], parallelism=7)
    withnulls = rt.data.from_items([{"v": None}] * 10 + [{"v": float(v)} for v in vals],
                                   parallelism=6)
    one = rt.data.from_items([{"v": 2.5}])
    nan = rt.data.from_items([{"v": v} for v in (1.0, float("nan"), 3.0, 4.0)], parallelism=2)
    got = agree("aggs", rt, (
        ds.std("v"), withnulls.std("v"), withnulls.sum("v"), withnulls.mean("v"),
        ds.quantile("v", 0.5), ds.quantile("v", 0.33), ds.quantile("g", 0.9),
        ds.unique("g"), withnulls.quantile("v", 0.25), one.std("v"), one.std("v", ddof=0),
        nan.min("v"), nan.max("v"), nan.sum("v"), nan.quantile("v", 0.5),
        ds.std("v", ddof=0)), rel=AGG_REL)
    assert got[0] == pytest.approx(np.std(vals, ddof=1), rel=1e-12)
    assert got[7] == [0, 1, 2]


def test_multi_key_groupby_and_named_aggregates(rt):
    rows = [{"a": i % 2, "b": i % 3, "v": float(i), "n": i} for i in range(60)]
    ds = rt.data.from_items(rows, parallelism=5)
    out = ds.groupby(["a", "b"]).aggregate(
        ("v", "sum"), ("v", "mean"), ("v", "stddev"), ("n", "max"),
        ("n", "count"), ("n", "count_distinct"), ("v", "variance"),
        ("n", "stddev", ("VarianceOptions", {"ddof": 1}))).take_all()
    mg = ds.groupby(["a", "b"]).map_groups(
        lambda batch: {"a": batch["a"][:1], "b": batch["b"][:1],
                       "n": np.array([len(batch["v"])])},
        batch_format="numpy").take_all()
    single = rt.data.from_items([{"k": i, "v": float(i)} for i in range(3)])
    agree("named_aggs", rt, (out, ds.groupby("a").std("v").take_all(), mg,
                             single.groupby("k").std("v").take_all()), rel=AGG_REL)


def test_unknown_aggregate_raises_naming_it(rt):
    """JAX hands any pyarrow function to Arrow; the port computes a fixed
    set and names what it does not."""
    ds = rt.data.from_items([{"k": 1, "v": 2.0}])
    if rt is ray_tpu:
        assert ds.groupby("k").aggregate(("v", "approximate_median")).count() == 1
        return
    with pytest.raises(ValueError, match="approximate_median"):
        ds.groupby("k").aggregate(("v", "approximate_median"))
    with pytest.raises(ValueError, match="QuantileOptions"):
        ds.groupby("k").aggregate(("v", "stddev", ("QuantileOptions", {"q": 0.5})))


def test_empty_datasets(rt):
    empty = rt.data.from_items([])
    agree("empty", rt, (empty.count(), empty.take_all(), empty.schema() is None,
                        rt.data.range(0).count(), rt.data.range(5).filter(lambda r: False).count(),
                        rt.data.range(5).limit(0).count(),
                        list(rt.data.range(0).iter_batches(batch_size=4))))


def test_read_json_matches_pyarrow_types(rt, tmp_path):
    """read_json gives the rows and dtypes pyarrow.json infers: ints,
    floats, bools, strings, lists, nested objects, missing keys (null)."""
    d = tmp_path / "j"
    d.mkdir()
    rng = np.random.default_rng(0)
    with open(d / "a.json", "w") as f:
        for i in range(6):
            row = {"i": i, "f": float(rng.normal()), "b": bool(i % 2), "s": f"r{i}",
                   "obs": rng.normal(size=3).tolist(), "ids": [i, i + 1],
                   "mixed": i if i % 2 else i + 0.5, "o": {"k": i}}
            if i != 2:
                row["opt"] = i * 10
            f.write(json.dumps(row) + "\n")
    ds = rt.data.read_json(str(d))
    rows = ds.take_all()
    agree("read_json", rt, (rows, ds.to_numpy()))


def test_read_write_mongo_with_injected_client(rt):
    class _Coll:
        def __init__(self, docs):
            self.docs, self.inserted = docs, []

        def find(self):
            return iter(self.docs)

        def aggregate(self, pipeline):
            out = self.docs
            for stage in pipeline:
                if "$match" in stage:
                    out = [d for d in out
                           if all(d.get(k) == v for k, v in stage["$match"].items())]
            return iter(out)

        def insert_many(self, rows):
            self.inserted.extend(rows)

    class _Client:
        def __init__(self, docs):
            self.coll = _Coll(docs)

        def __getitem__(self, _db):
            return {"c": self.coll}

        def close(self):
            pass

    client = _Client([{"_id": i, "x": i, "tag": "a" if i % 2 == 0 else "b"}
                      for i in range(10)])
    rows = rt.data.read_mongo(database="db", collection="c",
                              client_factory=lambda: client).take_all()
    sharded = rt.data.read_mongo(
        database="db", collection="c",
        pipelines=[[{"$match": {"tag": "a"}}], [{"$match": {"tag": "b"}}]],
        client_factory=lambda: client).take_all()
    out = _Client([])
    rt.data.from_items([{"y": i} for i in range(5)]).write_mongo(
        database="db", collection="c", client_factory=lambda: out)
    agree("mongo", rt, (rows, sharded, out.coll.inserted))


def test_read_write_bigquery_with_injected_client(rt):
    class _Result:
        def __init__(self, rows):
            self._rows = rows

        def __iter__(self):
            return iter(self._rows)

    class _Job:
        def __init__(self, rows):
            self.rows = rows

        def result(self):
            return _Result(self.rows)

    class _Client:
        def __init__(self, rows):
            self.rows, self.loaded = rows, []

        def query(self, q):
            return _Job(self.rows)

        def load_table_from_dataframe(self, df, dataset):
            self.loaded.append((dataset, len(df), list(df.columns)))
            return _Job([])

    client = _Client([{"a": i, "b": f"s{i}"} for i in range(7)])
    got = rt.data.read_bigquery(dataset="d.t", client_factory=lambda: client).take_all()
    rt.data.from_items([{"z": 1}, {"z": 2}]).write_bigquery(
        dataset="d.out", client_factory=lambda: client)
    agree("bigquery", rt, (sorted(got, key=lambda r: r["a"]), client.loaded))


# -- the scenarios of tests/test_data_operator_graph.py -----------------------

def _make_udfs():
    """UDFs built per test (cloudpickle sends them by value: the test
    module does not import in a worker)."""
    def slow_double(batch):
        time.sleep(0.05)
        return {"id": np.asarray(batch["id"]) * 2}

    class SlowAddOne:
        def __call__(self, batch):
            time.sleep(0.05)
            return {"id": np.asarray(batch["id"]) + 1}

    return slow_double, SlowAddOne


def test_multi_stage_pipeline_overlaps(rt, tmp_path):
    slow_double, SlowAddOne = _make_udfs()
    ds = (rt.data.range(64, parallelism=16).map_batches(slow_double)
          .map_batches(SlowAddOne, concurrency=2))
    ds.write_parquet(str(tmp_path / "out"))
    stages = ds._last_stats.stages
    assert stages[0].overlaps(stages[1]), ds.stats()
    assert stages[0].peak_in_flight > 1, ds.stats()
    back = rt.data.read_parquet(str(tmp_path / "out"))
    agree("overlap", rt, (sorted(r["id"] for r in back.take_all()),
                          [(st.name, st.tasks) for st in stages]))


def test_inter_operator_queues_bounded(rt):
    slow_double, SlowAddOne = _make_udfs()
    ds = rt.data.range(200, parallelism=50).map_batches(SlowAddOne, concurrency=1)
    vals = [r["id"] for r in ds.take_all()]
    actor_stage = ds._last_stats.stages[-1]
    assert actor_stage.peak_queue <= 4 and actor_stage.peak_in_flight <= 2, ds.stats()
    agree("bounded", rt, vals)


def test_ordering_preserved_through_graph(rt):
    slow_double, _ = _make_udfs()
    ds = rt.data.range(40, parallelism=8).map_batches(slow_double)
    out = [r["id"] for r in ds.take_all()]
    assert out == [2 * i for i in range(40)]
    agree("ordering", rt, out)


def test_barrier_segments_still_work(rt):
    slow_double, SlowAddOne = _make_udfs()
    ds = (rt.data.range(30, parallelism=6).map_batches(slow_double)
          .sort("id", descending=True).map_batches(SlowAddOne, concurrency=1))
    agree("barrier", rt, [r["id"] for r in ds.take_all()])


def test_consumer_pull_paces_execution(rt):
    slow_double, _ = _make_udfs()
    limited = rt.data.range(1000, parallelism=100).map_batches(slow_double).limit(10)
    first = limited.take_all()
    assert limited._last_stats.stages[0].tasks < 60, limited.stats()
    agree("paced", rt, first)
