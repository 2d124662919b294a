"""The port's shared-memory object store against the JAX package's.

`ray_tpu_torch/csrc/object_store.cc` builds with g++ into
`ray_tpu_torch/_build/` at first use. The same seeded sequence of create,
seal, get, release, evict, delete and abort runs on it and on JAX's store,
each in a directory of its own under a small capacity (so creates evict and
fill up), and must give the same return codes, sizes, counts and bytes. The
Python clients then put and get the same values through both.
"""
import ctypes
import os

import numpy as np
import pytest

from ray_tpu.core import object_store as jstore
from ray_tpu.core.ids import ObjectID as JaxObjectID
from ray_tpu_torch.core import object_store as tstore
from ray_tpu_torch.core import store_build
from ray_tpu_torch.core.ids import ObjectID

CAPACITY = 64 * 1024
IDS = [bytes([i]) * 20 for i in range(1, 13)]


def _sequence(lib, directory: str, seed: int) -> list:
    """A seeded run of store calls; what each returned (and read)."""
    rng = np.random.default_rng(seed)
    handle = lib.rts_connect(directory.encode(), CAPACITY, 1024)
    assert handle
    out, held = [], []
    try:
        for _ in range(400):
            op = rng.choice(["create", "create", "seal", "get", "get", "release",
                             "evict", "delete", "abort"])
            oid = IDS[int(rng.integers(len(IDS)))]
            if op == "create":
                size = int(rng.integers(1, 16 * 1024))
                fd = ctypes.c_int(-1)
                rc = lib.rts_create(handle, oid, size, ctypes.byref(fd))
                if rc == 0:
                    os.pwrite(fd.value, rng.bytes(size), 0)
                    os.close(fd.value)
                else:
                    rng.bytes(size)   # the same draws either way
                out.append((op, rc, size))
            elif op == "seal":
                out.append((op, lib.rts_seal(handle, oid)))
            elif op == "abort":
                out.append((op, lib.rts_abort(handle, oid)))
            elif op == "get":
                size, fd = ctypes.c_uint64(0), ctypes.c_int(-1)
                rc = lib.rts_get(handle, oid, ctypes.byref(size), ctypes.byref(fd))
                data = b""
                if rc == 0:
                    data = os.pread(fd.value, size.value, 0)
                    os.close(fd.value)
                    held.append(oid)
                out.append((op, rc, size.value, data))
            elif op == "release":
                target = held.pop(int(rng.integers(len(held)))) if held else oid
                out.append((op, lib.rts_release(handle, target)))
            elif op == "evict":
                out.append((op, int(lib.rts_evict(handle, int(rng.integers(1, 32 * 1024))))))
            else:
                out.append((op, lib.rts_delete(handle, oid, int(rng.integers(2)))))
            out.append(("state", int(lib.rts_used(handle)),
                        int(lib.rts_num_objects(handle)),
                        [lib.rts_contains(handle, i) for i in IDS]))
    finally:
        lib.rts_disconnect(handle)
    return out


def test_the_store_builds_from_the_port_sources():
    path = store_build.library_path()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(tstore.__file__)))
    assert path == os.path.join(pkg, "_build", "libray_tpu_torch_store.so")
    assert os.path.exists(path)
    assert os.path.getmtime(path) >= os.path.getmtime(
        os.path.join(pkg, "csrc", "object_store.cc"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_seeded_sequence_matches_jax(tmp_path, seed):
    want = _sequence(jstore.get_lib(), str(tmp_path / "jax"), seed)
    got = _sequence(tstore.get_lib(), str(tmp_path / "port"), seed)
    ops = {step[0] for step in want}
    assert {"create", "seal", "get", "release", "evict", "delete"} <= ops
    # The capacity is small enough that a create fills the store at least once.
    assert any(s[0] == "create" and s[1] == jstore.RTS_ERR_FULL for s in want) or any(
        s[0] == "evict" and s[1] > 0 for s in want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g[:3], w[:3])


def test_the_python_clients_put_and_get_the_same_values(tmp_path):
    values = [np.arange(100_000, dtype=np.float32), {"a": [1, 2], "b": "x"},
              b"\x00" * 5000, ValueError("boom")]
    stores = (jstore.ObjectStore(str(tmp_path / "jax"), capacity=1 << 24),
              tstore.ObjectStore(str(tmp_path / "port"), capacity=1 << 24))
    try:
        seen = []
        for store, idcls in zip(stores, (JaxObjectID, ObjectID)):
            got = []
            for i, v in enumerate(values):
                oid = idcls(bytes([i + 1]) * 20)
                store.put(oid, v, is_error=isinstance(v, Exception))
                assert store.contains(oid)
                try:
                    value, buf = store.get(oid)
                    got.append(value.tobytes() if isinstance(value, np.ndarray)
                               else value)
                except ValueError as e:
                    got.append(("raised", str(e)))
                assert store.delete(oid, force=True)
            seen.append(got)
        assert seen[0] == seen[1]
    finally:
        for store in stores:
            store.disconnect()
