"""The streaming data plane of ray_tpu_torch against ray_tpu's, on the CPU.

Each runtime starts one single-host cluster for this file
(`init(num_cpus=4)`) and shuts it down in `finally`, never both at once.
The scenarios are those of tests/test_data_streaming.py (the byte-budgeted
executor's stats, the legacy fallback, backpressure, the spill fallback
and BackpressureTimeout, the bundle shuffle and its layout, the split's
ack on a consumer's death, the prefetcher, the data gauges, the device
feed) and tests/test_data_elastic_split.py (grow and shrink mid-epoch, a
SIGKILLed consumer through `util/chaos.py`), plus StreamingIngest feeding
each package's trainer. JAX's run records what it got and the port's run
is held to the record: rows exactly, dtypes included.
"""
import importlib
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

RECORD = {}


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


KNOBS = ("data_stream_enabled", "data_stream_window_bytes",
         "data_stream_op_inflight_bytes", "data_stream_spill_threshold",
         "data_stream_stall_timeout_s", "data_stream_prefetch_depth")


@pytest.fixture
def cfg(rt):
    cfg = importlib.import_module(f"{rt.__name__}.core.config").get_config()
    keep = {k: getattr(cfg, k) for k in KNOBS}
    try:
        yield cfg
    finally:
        for k, v in keep.items():
            setattr(cfg, k, v)


def agree(name, rt, got):
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


def ids(rt, blk):
    return blk.column("id").to_pylist() if rt is ray_tpu else blk["id"].tolist()


def test_streaming_is_default_and_correct(rt, cfg):
    assert cfg.data_stream_enabled
    ds = rt.data.range(64, parallelism=4).map_batches(lambda b: {"x": b["id"] * 2},
                                                      batch_format="numpy")
    out = ds.to_numpy()["x"]
    agree("default", rt, (out.dtype.str, out.tolist()))


def test_per_operator_byte_stats_populated(rt):
    ds = rt.data.range(200, parallelism=4).map_batches(
        lambda b: {"x": b["id"].astype(np.float64)}, batch_format="numpy")
    ds.to_numpy()
    stats = ds._last_stats
    assert [st for st in stats.stages if st.bytes_out]
    assert all(st.peak_inflight_bytes >= 0 for st in stats.stages)
    s = ds.stats()
    assert "MB out" in s and "stalled" in s
    # The blocks are 50 float64 rows: 400 bytes each in both packages.
    agree("byte_stats", rt, [(st.name, st.tasks, st.rows_out, st.bytes_out)
                             for st in stats.stages])


def test_legacy_fallback_knob(rt, cfg):
    cfg.data_stream_enabled = False
    ds = rt.data.range(50, parallelism=3).map(lambda r: r["id"] + 1)
    rows = [int(x) for x in ds.take_all()]
    assert all(st.bytes_out == 0 for st in ds._last_stats.stages)
    agree("legacy", rt, rows)


def test_tiny_op_cap_backpressures_but_completes(rt, cfg):
    cfg.data_stream_op_inflight_bytes = 1   # every block overruns the cap
    ds = rt.data.range(128, parallelism=8).map_batches(lambda b: {"x": b["id"] * 3},
                                                       batch_format="numpy")
    out = ds.to_numpy()["x"].tolist()
    assert max(st.peak_inflight_bytes for st in ds._last_stats.stages) >= 1
    agree("op_cap", rt, out)


def _add_seven_udf():
    """Class UDF -> actor operator, so the graph has two operators and the
    global byte window an inter-operator hop to squeeze. Defined in a
    function so it pickles by value into the actor worker."""

    class AddSeven:
        def __call__(self, batch):
            return {"x": batch["id"] + 7}

    return AddSeven


def test_spill_fallback_keeps_graph_live(rt, cfg):
    cfg.data_stream_window_bytes = 1        # global window always exceeded
    cfg.data_stream_spill_threshold = 1.0   # store never "too full" to spill
    ds = rt.data.range(64, parallelism=4).map_batches(_add_seven_udf(),
                                                      batch_format="numpy",
                                                      concurrency=1)
    out = ds.to_numpy()["x"].tolist()
    assert sum(st.spilled_tasks for st in ds._last_stats.stages) >= 1
    agree("spill", rt, out)


def test_backpressure_timeout_when_spill_disallowed(rt, cfg):
    cfg.data_stream_window_bytes = 1
    cfg.data_stream_spill_threshold = 0.0   # no spill headroom, ever
    cfg.data_stream_stall_timeout_s = 0.4
    ds = rt.data.range(64, parallelism=4).map_batches(_add_seven_udf(),
                                                      batch_format="numpy",
                                                      concurrency=1)
    exc = importlib.import_module(f"{rt.__name__}.exceptions")
    with pytest.raises(exc.BackpressureTimeout) as ei:
        ds.to_numpy()
    e = ei.value
    assert isinstance(e, exc.DataPlaneError) and isinstance(e, TimeoutError)
    e2 = pickle.loads(pickle.dumps(e))
    assert e2.operator == e.operator and e2.waited_s == e.waited_s
    agree("timeout", rt, e.operator)


def test_streaming_shuffle_preserves_rows_and_order(rt):
    """Every row once, in JAX's order for the same seed, through fused map
    stages; the shuffle's bytes land in the data gauges."""
    ds = (rt.data.range(300, parallelism=6)
          .map_batches(lambda b: {"id": b["id"], "sq": b["id"] ** 2}, batch_format="numpy")
          .random_shuffle(seed=7))
    rows = [(int(r["id"]), int(r["sq"])) for r in ds.take_all()]
    assert sorted(rows) == [(i, i * i) for i in range(300)]
    if rt is ray_tpu_torch:
        from ray_tpu_torch.util.metrics import registry_dump

        names = {m["name"] for m in registry_dump()}
        assert {"data_shuffle_bytes", "data_shuffle_seconds", "data_shuffle_gbps"} <= names
    agree("shuffle", rt, rows)


def test_shuffle_bundle_roundtrip_and_range_layout():
    """The bundle's offset header tiles its parts back to back (the
    property a range pull relies on), and each part is a frame that gives
    its block back, object and tensor columns included."""
    from ray_tpu_torch.data.streaming import shuffle as sh

    blocks = [{"v": np.arange(i * 10, i * 10 + 5), "s": np.array(list("abcde"), object),
               "t": np.arange(20.0).reshape(5, 2, 2) + i} for i in range(3)]
    blocks.append({"v": np.arange(0), "s": np.empty(0, object), "t": np.empty((0, 2, 2))})
    bundle = sh.pack_bundle([sh.block_to_frame(b) for b in blocks])
    slots = sh.parse_header(bundle)
    assert len(slots) == 4 and slots[0][0] == sh.header_size(4)
    for (o1, l1), (o2, _) in zip(slots, slots[1:]):
        assert o1 + l1 == o2
    assert slots[-1][0] + slots[-1][1] == len(bundle)
    for j, b in enumerate(blocks):
        got = sh.part_block(bundle, j)
        assert list(got) == list(b)
        for k in b:
            assert got[k].dtype == b[k].dtype and got[k].shape == b[k].shape
            np.testing.assert_array_equal(got[k], b[k])
    with pytest.raises(ValueError, match="magic"):
        sh.parse_header(np.zeros(64, np.uint8))


def test_scatter_and_combine_give_jax_rows():
    """One mapper's partitions and one reducer's rows equal JAX's
    `_scatter_bundle`/`_combine_part` on the same block and seeds."""
    import pyarrow as pa

    from ray_tpu.data.streaming import shuffle as jsh
    from ray_tpu_torch.data.streaming import shuffle as tsh

    rng = np.random.default_rng(0)
    cols = {"id": np.arange(37), "x": rng.normal(size=37)}
    jbundle, _ = jsh._scatter_bundle(pa.table(cols), 3, 11)
    tbundle, _ = tsh._scatter_bundle(cols, 3, 11)
    for j in range(3):
        want = jsh.part_table(jbundle, j)
        got = tsh.part_block(tbundle, j)
        assert got["id"].tolist() == want.column("id").to_pylist()
        assert got["x"].tolist() == want.column("x").to_pylist()
    want = jsh._combine_part(5, 1, jbundle, jbundle)
    got = tsh._combine_part(5, 1, tbundle, tbundle)
    assert got["id"].tolist() == want.column("id").to_pylist()


def test_streaming_split_ack_requeues_on_death(rt):
    ds = rt.data.range(40, parallelism=4)
    it0, it1 = ds.streaming_split(2)
    coord = it0._coord
    first = rt.get(coord.next_block.remote(0))
    assert first is not None
    rt.get(coord.mark_dead.remote(0))
    seen = []
    for blk in it1.iter_blocks():
        seen.extend(ids(rt, blk))
    assert sorted(seen) == list(range(40))
    prog = rt.get(coord.progress.remote())
    assert prog["exhausted"] and prog["outstanding"] == 0
    agree("ack", rt, (seen, prog))


def test_device_prefetcher_overlap_and_order():
    from ray_tpu_torch.data.streaming.prefetch import DevicePrefetcher

    pf = DevicePrefetcher(iter(range(20)), lambda x: x * 2, depth=2, name="t")
    assert list(pf) == [x * 2 for x in range(20)]
    assert pf.hits + pf.misses == 21   # 20 items + the StopIteration pull


def test_device_prefetcher_propagates_errors_and_closes():
    from ray_tpu_torch.data.streaming.prefetch import DevicePrefetcher

    def bad():
        yield 1
        raise ValueError("upstream exploded")

    with pytest.raises(ValueError, match="upstream exploded"):
        list(DevicePrefetcher(bad(), lambda x: x, depth=2, name="t"))
    pf = DevicePrefetcher(iter(range(1000)), lambda x: x, depth=2, name="t")
    assert next(pf) == 0
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()


def test_data_plane_gauges_registered_after_execution(rt):
    metrics = importlib.import_module(f"{rt.__name__}.util.metrics")
    ds = rt.data.range(100, parallelism=4).map_batches(lambda b: {"x": b["id"]},
                                                       batch_format="numpy")
    ds.to_numpy()
    names = {m["name"] for m in metrics.registry_dump()}
    assert {"data_op_bytes_in_flight", "data_op_stall_seconds"} <= names
    if rt is ray_tpu_torch:
        with ds.iter_device_batches(batch_size=16, device="cpu") as feed:
            n = sum(len(b["x"]) for b in feed)
        assert n == 96
        names = {m["name"] for m in metrics.registry_dump()}
        assert {"data_prefetch_hits", "data_prefetch_misses"} & names


def test_device_batches_streaming_feed(rt):
    """iter_jax_batches' counterpart over the streaming path and over a
    streaming_split shard, on the CPU: the same batches as JAX's arrays."""
    ds = rt.data.range(64, parallelism=4)
    (shard,) = ds.streaming_split(1)
    if rt is ray_tpu:
        got = [[np.asarray(b["id"]).tolist() for b in src.iter_jax_batches(batch_size=16)]
               for src in (ds, shard)]
    else:
        got = []
        for src in (ds, shard):
            with src.iter_device_batches(batch_size=16, device="cpu",
                                         dtypes={"id": np.int32}) as feed:
                batches = list(feed)
            assert all(b["id"].dtype.is_floating_point is False for b in batches)
            got.append([b["id"].tolist() for b in batches])
    agree("device_feed", rt, got)


# -- the scenarios of tests/test_data_elastic_split.py -------------------------

def _consume_blocks(rt, coord, idx: int, k: int):
    rows = []
    for _ in range(k):
        ref = rt.get(coord.next_block.remote(idx))
        assert ref is not None
        rows.extend(ids(rt, rt.get(ref)))
    rt.get(coord.ack.remote(idx))
    return rows


def _drain_round_robin(rt, iterators):
    gens = [it.iter_blocks() for it in iterators]
    rows = []
    while gens:
        alive = []
        for g in gens:
            try:
                blk = next(g)
            except StopIteration:
                continue
            rows.extend(ids(rt, blk))
            alive.append(g)
        gens = alive
    return rows


@pytest.mark.parametrize("grow", [True, False], ids=["grow", "shrink"])
def test_resize_mid_epoch_no_restart_no_dupes(rt, grow):
    ds = rt.data.range(120, parallelism=12)
    ingest = rt.data.StreamingIngest(ds)
    before, after = (2, 3) if grow else (3, 2)
    for r in range(before):
        ingest.shard(r, before)
    coord = ingest.coordinator
    seen = []
    for r in range(before):
        seen += _consume_blocks(rt, coord, r, 2 if grow else 1)
    its = [ingest.shard(r, after) for r in range(after)]
    assert ingest.coordinator is coord
    if not grow:
        assert rt.get(coord.next_block.remote(2)) is None   # a stale consumer
    seen += _drain_round_robin(rt, its)
    assert sorted(seen) == list(range(120))
    prog = rt.get(coord.progress.remote())
    assert prog["epoch_id"] == 0 and prog["resplits"] == 1
    assert prog["exhausted"] and prog["outstanding"] == 0
    agree(f"resize_{grow}", rt, (seen, prog))


def _consumer_actor_cls(rt):
    """Defined in a function so it pickles by value into the worker."""
    arrow = rt is ray_tpu

    def ids(rt, blk):
        return blk.column("id").to_pylist() if arrow else blk["id"].tolist()

    class SplitConsumer:
        def __init__(self, coord, idx):
            self._coord = coord
            self._idx = idx

        def pid(self):
            return os.getpid()

        def pull_one_uncommitted(self):
            ref = rt.get(self._coord.next_block.remote(self._idx))
            assert ref is not None
            return len(ids(rt, rt.get(ref)))

        def drain(self):
            rows = []
            ref = rt.get(self._coord.next_block.remote(self._idx))
            while ref is not None:
                rows.extend(ids(rt, rt.get(ref)))
                ref = rt.get(self._coord.next_block.remote(self._idx))
            return rows

    return SplitConsumer


def test_sigkill_one_consumer_survivor_gets_every_sample(rt):
    chaos = importlib.import_module(f"{rt.__name__}.util.chaos")
    ds = rt.data.range(60, parallelism=6)
    it0, _ = ds.streaming_split(2)
    coord = it0._coord
    SplitConsumer = rt.remote(_consumer_actor_cls(rt))
    victim, survivor = SplitConsumer.remote(coord, 0), SplitConsumer.remote(coord, 1)
    assert rt.get(victim.pull_one_uncommitted.remote()) > 0
    assert chaos.kill_rank(SimpleNamespace(pids=[rt.get(victim.pid.remote())]), 0)
    rt.get(coord.mark_dead.remote(0))
    rows = rt.get(survivor.drain.remote(), timeout=120)
    assert sorted(rows) == list(range(60))
    prog = rt.get(coord.progress.remote())
    assert prog["epoch_id"] == 0 and prog["exhausted"] and prog["outstanding"] == 0
    agree("sigkill", rt, sorted(rows))


def test_streaming_ingest_feeds_the_trainer(rt, tmp_path):
    """`datasets={"train": StreamingIngest(ds)}` through each package's
    trainer, one CPU worker: the worker reads its shard in order (JAX's
    with iter_batches, the port's with iter_device_batches on the CPU,
    as phase 22a reads it on the card), and every row comes once."""
    train = rt.train
    ds = rt.data.from_items([{"row": i, "x": float(i)} for i in range(40)], parallelism=5)
    port = rt is ray_tpu_torch

    def loop(config):
        shard = train.get_dataset_shard("train")
        if port:
            with shard.iter_device_batches(batch_size=8, device="cpu") as feed:
                got = [b["row"].tolist() for b in feed]
        else:
            got = [b["row"].tolist() for b in shard.iter_batches(batch_size=8,
                                                                 batch_format="numpy")]
        train.report({"batches": got})

    kw = {"use_gpu": False} if port else {}
    trainer = train.DataParallelTrainer(
        loop, backend=None, train_loop_config={},
        datasets={"train": rt.data.StreamingIngest(ds)},
        scaling_config=train.ScalingConfig(num_workers=1, resources_per_worker={"CPU": 1},
                                           **kw),
        run_config=train.RunConfig(name="ingest", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None, result.error
    batches = result.metrics["batches"]
    assert sum(batches, []) == list(range(40))
    agree("ingest", rt, batches)
