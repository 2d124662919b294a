"""The port's device feed (`ray_tpu_torch/data/feed.py`) on the CPU: the
prefetcher's semantics as the JAX package's `DevicePrefetcher` has them,
and the rows each rank of a mesh receives against JAX's layout of
PartitionSpec(("dp", "fsdp")).
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.distributed.tensor import DTensor

from ray_tpu.parallel import MeshConfig as JaxMeshConfig, build_mesh as jax_build_mesh
from ray_tpu_torch.data import DevicePrefetcher, device_prefetching, torch_feed
from ray_tpu_torch.parallel import mesh

WAIT_S = 10


def _batches(n, rows=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 512, (rows, 5), dtype=np.int32)}
            for _ in range(n)]


def test_order_preserved_and_batches_copied():
    batches = _batches(6)
    with torch_feed(iter(batches), device="cpu", dtypes={"tokens": np.int64}) as feed:
        got = list(feed)
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert g["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(g["tokens"].numpy(), b["tokens"])
    batches[0]["tokens"][:] = -1  # the feed copied: its batch keeps its values
    assert int(got[0]["tokens"].min()) >= 0
    assert feed.hits + feed.misses == len(batches) + 1  # + the end


def _wait_until(cond):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def test_depth_bounds_the_batches_pulled_ahead():
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield i

    pf = DevicePrefetcher(source(), lambda b: b, depth=3)
    try:
        _wait_until(lambda: pf._q.full())
        time.sleep(0.2)
        # depth batches queued, one more blocked in put: no further pull.
        assert len(pulled) == 3 + 1
        assert next(pf) == 0 and pf.hits == 1 and pf.misses == 0
        _wait_until(lambda: len(pulled) == 3 + 2)
    finally:
        pf.close()


def test_close_stops_the_producer():
    stop = threading.Event()

    def endless():
        while not stop.is_set():
            yield 0

    pf = DevicePrefetcher(endless(), lambda b: b, depth=2)
    assert next(pf) == 0
    pf.close()
    pf._thread.join(timeout=WAIT_S)
    assert not pf._thread.is_alive()

    gen = device_prefetching(endless(), lambda b: b, depth=2)
    assert next(gen) == 0
    gen.close()  # the consumer leaves early: the wrapper closes the producer
    stop.set()


def test_source_error_is_raised_at_the_consumer():
    def failing():
        yield from _batches(2)
        raise ValueError("bad shard")

    feed = torch_feed(failing(), device="cpu")
    assert len([next(feed), next(feed)]) == 2
    with pytest.raises(ValueError, match="bad shard"):
        next(feed)


LAYOUTS = [dict(dp=2, fsdp=2), dict(fsdp=4), dict(dp=4), dict(dp=2, fsdp=2, tp=2),
           dict(fsdp=2, tp=2), dict(dp=2, fsdp=1, sp=2, tp=2)]


@pytest.mark.parametrize("sizes", LAYOUTS, ids=[str(s) for s in LAYOUTS])
def test_rows_of_each_rank_match_jax_batch_layout(sizes):
    """Rank r sits at the row-major position r of the mesh, as JAX's
    build_mesh lays devices out on the CPU; each holds the rows that
    P(("dp", "fsdp")) gives the device there."""
    sizes = {"fsdp": 1, **sizes}
    n = int(np.prod(list(sizes.values())))
    jmesh = jax_build_mesh(JaxMeshConfig(**sizes), devices=jax.devices()[:n])
    shape = (16, 3)
    index = NamedSharding(jmesh, P(("dp", "fsdp"))).devices_indices_map(shape)
    full = mesh.MeshConfig(**sizes).resolve(n)
    names = mesh._CANONICAL_ORDER
    for rank, coord in enumerate(np.ndindex(*(full[a] for a in names))):
        rows = mesh.batch_rows(shape[0], full, dict(zip(names, coord)), ("dp", "fsdp"))
        assert rows == index[jax.devices()[rank]][0]


def test_mesh_feed_yields_dtensors_of_the_global_batch():
    try:
        m = mesh.build_mesh(device_type="cpu")
        batches = _batches(2)
        with torch_feed(iter(batches), device="cpu", mesh=m) as feed:
            for got, want in zip(feed, batches):
                assert isinstance(got["tokens"], DTensor)
                assert tuple(got["tokens"].shape) == want["tokens"].shape
                np.testing.assert_array_equal(got["tokens"].full_tensor().numpy(),
                                              want["tokens"])
    finally:
        dist.destroy_process_group()


def test_cuda_feed_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_feed(iter(_batches(1)), device="cuda")
