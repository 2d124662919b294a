"""The multi-process runtime of ray_tpu_torch against ray_tpu's, on the CPU.

Each runtime starts one single-host cluster for this file (`init(num_cpus=3)`:
GCS, node daemon, zygote-forked workers, shared-memory store), never both at
once, and shuts it down in `finally`. Every scenario of
tests/test_cluster_runtime.py, and tasks in env_vars and working_dir runtime
envs, run through both and must give the same values, error type names and
masked messages: JAX's run records what it got, the port's run is held to
the record. Around them: a port worker
imports neither JAX nor ray_tpu, the GPU count given through the port's
override is scheduled as JAX schedules its TPU override, tensors and arrays
cross worker processes bit for bit, the zygote keeps its fork contract
(one thread, CUDA not initialised), and a second driver joins through
`init(address=...)` while a driver of the other runtime is refused.
"""
import importlib
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Each runtime's accelerator override and the resource it fills.
ACCEL = {ray_tpu: ("RAY_TPU_NUM_TPUS", "TPU", "num_tpus"),
         ray_tpu_torch: ("RAY_TPU_NUM_GPUS", "GPU", "num_gpus")}
RECORD = {}   # scenario -> what the JAX package's cluster gave


def _mask(text: str) -> str:
    text = re.sub(r"[0-9a-f]{8,}", "<id>", str(text))
    return re.sub(r"pid=\d+", "pid=<pid>", text)


def _error(exc: BaseException) -> tuple:
    """An error as a caller sees it: type name and masked message (a
    TaskError by its function and the traceback's last line)."""
    if hasattr(exc, "traceback_str"):
        last = exc.traceback_str.strip().splitlines()[-1]
        return type(exc).__name__, exc.function_name, _mask(last)
    return type(exc).__name__, _mask(str(exc))


@pytest.fixture(scope="module", params=[ray_tpu, ray_tpu_torch],
                ids=["ray_tpu", "ray_tpu_torch"])
def cluster(request):
    rt = request.param
    for other in (ray_tpu, ray_tpu_torch):
        if other.is_initialized():
            other.shutdown()
    var = ACCEL[rt][0]
    before = os.environ.get(var)
    os.environ[var] = "1"
    try:
        rt.init(num_cpus=3)
        yield rt
    finally:
        rt.shutdown()
        if before is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = before


def _agree(name: str, rt, got):
    """Record JAX's result; hold the port's to it."""
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


# -- the scenarios of test_cluster_runtime.py --------------------------------

def s_task_roundtrip(rt, tmp_path):
    @rt.remote
    def mul(a, b):
        return a * b

    return rt.get(mul.remote(6, 7))


def s_put_get_and_refs_as_args(rt, tmp_path):
    x = rt.put(np.arange(1000))

    @rt.remote
    def total(arr):
        return int(arr.sum())

    return rt.get(total.remote(x))


def s_nested_task_submission(rt, tmp_path):
    @rt.remote
    def inner(x):
        return x + 1

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) * 10

    return rt.get(outer.remote(3))


def s_task_error_and_traceback(rt, tmp_path):
    @rt.remote
    def broken():
        return {}["missing"]

    try:
        rt.get(broken.remote())
    except rt.exceptions.TaskError as e:
        return _error(e)
    raise AssertionError("no error raised")


def s_num_returns_distributed(rt, tmp_path):
    @rt.remote(num_returns=2)
    def pair():
        return "a", "b"

    a, b = pair.remote()
    return rt.get([a, b])


def s_actor_state_and_ordering(rt, tmp_path):
    @rt.remote
    class Acc:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)

        def snapshot(self):
            return list(self.items)

    a = Acc.remote()
    for i in range(25):
        a.add.remote(i)
    return rt.get(a.snapshot.remote())


def s_named_actor_distributed(rt, tmp_path):
    @rt.remote
    class Registry:
        def whoami(self):
            return "registry"

    Registry.options(name="reg", lifetime="detached").remote()
    h = rt.get_actor("reg")
    return rt.get(h.whoami.remote())


def s_actor_restart_after_crash(rt, tmp_path):
    @rt.remote(max_restarts=1)
    class Fragile:
        def __init__(self):
            self.count = 0

        def incr(self):
            self.count += 1
            return self.count

        def die(self):
            os._exit(1)

    f = Fragile.remote()
    first = rt.get(f.incr.remote())
    f.die.remote()
    deadline = time.monotonic() + 60
    while True:
        try:
            v = rt.get(f.incr.remote(), timeout=30)
            break
        except (rt.exceptions.ActorUnavailableError,
                rt.exceptions.GetTimeoutError):
            if time.monotonic() > deadline:
                raise
    return first, v


def s_actor_dies_permanently_without_restarts(rt, tmp_path):
    @rt.remote
    class OneShot:
        def die(self):
            os._exit(1)

        def ping(self):
            return "pong"

    a = OneShot.remote()
    pong = rt.get(a.ping.remote())
    a.die.remote()
    try:
        for _ in range(50):
            rt.get(a.ping.remote(), timeout=30)
            time.sleep(0.2)
    except (rt.exceptions.ActorDiedError,
            rt.exceptions.ActorUnavailableError) as e:
        return pong, type(e).__name__ in ("ActorDiedError",
                                          "ActorUnavailableError")
    raise AssertionError("the actor never died")


def s_task_retry_on_worker_crash(rt, tmp_path):
    marker = str(tmp_path / "attempted")

    @rt.remote(max_retries=2)
    def flaky():
        if not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)  # kill the worker on first attempt
        return "recovered"

    return rt.get(flaky.remote(), timeout=120)


def s_async_actor_distributed(rt, tmp_path):
    import asyncio

    @rt.remote
    class AsyncWorker:
        async def double(self, x):
            await asyncio.sleep(0.01)
            return x * 2

    a = AsyncWorker.remote()
    refs = [a.double.remote(i) for i in range(8)]
    return rt.get(refs, timeout=60)


def s_runtime_context_in_task(rt, tmp_path):
    @rt.remote
    def whereami():
        ctx = rt.get_runtime_context()
        return ctx.get_node_id(), ctx.get_pid()

    node_id, pid = rt.get(whereami.remote())
    return bool(node_id), pid != os.getpid()


def s_placement_group_single_node(rt, tmp_path):
    util = importlib.import_module(f"{rt.__name__}.util")
    strategies = importlib.import_module(
        f"{rt.__name__}.util.scheduling_strategies")
    pg = util.placement_group([{"CPU": 1}], strategy="PACK")
    ready = pg.ready(timeout=30)

    @rt.remote(
        num_cpus=1,
        scheduling_strategy=strategies.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0))
    def pinned():
        return "ran-in-pg"

    out = rt.get(pinned.remote(), timeout=60)
    util.remove_placement_group(pg)
    return ready, out


def s_wait_distributed(rt, tmp_path):
    @rt.remote
    def quick():
        return 1

    @rt.remote
    def slow():
        time.sleep(10)
        return 2

    q, s = quick.remote(), slow.remote()
    ready, pending = rt.wait([q, s], num_returns=1, timeout=8)
    return ready == [q], pending == [s]


def s_runtime_env_vars_and_working_dir(rt, tmp_path):
    """Not in test_cluster_runtime.py: a task with env_vars sees them and
    one without does not; a task with a working_dir runs in its unpacked
    copy, with it first on sys.path."""
    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "payload.txt").write_text("from the working dir")
    (wd / "rtenv_helper.py").write_text("VALUE = 17\n")

    @rt.remote(runtime_env={"env_vars": {"RTENV_PROBE": "on"}})
    def with_vars():
        return os.environ.get("RTENV_PROBE")

    @rt.remote
    def without():
        return os.environ.get("RTENV_PROBE")

    @rt.remote(runtime_env={"working_dir": str(wd)})
    def in_dir():
        import rtenv_helper

        with open("payload.txt") as f:
            return f.read(), rtenv_helper.VALUE, os.getcwd() != str(wd)

    return rt.get([with_vars.remote(), without.remote(), in_dir.remote()])


SCENARIOS = {
    "task_roundtrip": (s_task_roundtrip, 42),
    "put_get_and_refs_as_args": (s_put_get_and_refs_as_args, 499500),
    "nested_task_submission": (s_nested_task_submission, 40),
    "task_error_and_traceback": (
        s_task_error_and_traceback,
        ("TaskError", "s_task_error_and_traceback.<locals>.broken",
         "KeyError: 'missing'")),
    "num_returns_distributed": (s_num_returns_distributed, ["a", "b"]),
    "actor_state_and_ordering": (s_actor_state_and_ordering, list(range(25))),
    "named_actor_distributed": (s_named_actor_distributed, "registry"),
    "actor_restart_after_crash": (s_actor_restart_after_crash, (1, 1)),
    "actor_dies_permanently_without_restarts": (
        s_actor_dies_permanently_without_restarts, ("pong", True)),
    "task_retry_on_worker_crash": (s_task_retry_on_worker_crash, "recovered"),
    "async_actor_distributed": (s_async_actor_distributed,
                                [i * 2 for i in range(8)]),
    "runtime_context_in_task": (s_runtime_context_in_task, (True, True)),
    "placement_group_single_node": (s_placement_group_single_node,
                                    (True, "ran-in-pg")),
    "wait_distributed": (s_wait_distributed, (True, True)),
    "runtime_env_vars_and_working_dir": (
        s_runtime_env_vars_and_working_dir,
        ["on", None, ("from the working dir", 17, True)]),
}


# Scenarios whose actor the JAX daemon may start on a dead worker: after a
# task killed its worker (async actors), or on the restart that follows
# the actor's own death, under a loaded host.
JAX_RETRIES = ("async_actor_distributed", "actor_restart_after_crash")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(cluster, tmp_path, name):
    scenario, want = SCENARIOS[name]
    if cluster is ray_tpu and name in JAX_RETRIES:
        # The JAX package's daemon can hand a dead worker to an actor
        # (ROADMAP C): its run of these two may take one more try. The
        # port's may not.
        try:
            got = scenario(cluster, tmp_path)
        except (ray_tpu.exceptions.ActorDiedError,
                ray_tpu.exceptions.GetTimeoutError):
            got = scenario(cluster, tmp_path)
    else:
        got = scenario(cluster, tmp_path)
    assert _agree(name, cluster, got) == want
    if cluster is ray_tpu_torch and name == "task_retry_on_worker_crash":
        # The port's daemon confirms through /proc that a pooled worker
        # is alive before it grants it: a task that kills its worker, then
        # at once an actor, three times over, and every actor starts.
        for i in range(3):
            (tmp_path / str(i)).mkdir()
            assert s_task_retry_on_worker_crash(cluster, tmp_path / str(i)) == want
            assert s_async_actor_distributed(cluster, tmp_path) == [
                j * 2 for j in range(8)]


# -- what the port adds, or must keep apart ----------------------------------

def test_a_worker_imports_nothing_of_the_other_runtime(cluster):
    """A port worker has neither JAX nor ray_tpu loaded (and was forked by
    the zygote); a JAX worker has nothing of ray_tpu_torch."""
    other = (("ray_tpu_torch",) if cluster is ray_tpu
             else ("jax", "jaxlib", "ray_tpu"))
    package = cluster.__name__

    @cluster.remote
    def loaded():
        main = importlib.import_module(f"{package}.core.distributed.worker_main")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in other)
        return bad, getattr(main, "STARTED_BY", "zygote")

    assert cluster.get(loaded.remote()) == ([], "zygote")


def test_the_accelerator_override_schedules_as_jax(cluster):
    var, resource, option = ACCEL[cluster]
    total = cluster.cluster_resources()

    @cluster.remote
    class OnTheCard:
        def where(self):
            return "placed"

    @cluster.remote
    def too_many():
        return "ran"

    actor = OnTheCard.options(**{option: 1}).remote()
    placed = cluster.get(actor.where.remote(), timeout=60)
    ref = too_many.options(**{option: 2}).remote()
    ready, _ = cluster.wait([ref], num_returns=1, timeout=2)
    cluster.kill(actor)
    got = (total.get(resource), placed, ready == [])
    assert _agree("accelerator", cluster, got) == (1.0, "placed", True)


def test_tensors_and_arrays_cross_worker_processes_bit_for_bit(cluster):
    """Between two actors' processes, through each runtime's store (the
    JAX package pickles a tensor through torch's own reduction, the port
    as one out-of-band buffer)."""

    @cluster.remote
    class Holder:
        def make(self, seed):
            import torch as t

            g = t.Generator().manual_seed(seed)
            return {"f32": t.randn(33, 17, generator=g),
                    "bf16": t.randn(8, 64, generator=g).to(t.bfloat16),
                    "leaf": t.randn(5, generator=g).requires_grad_(),
                    "array": np.random.default_rng(seed).standard_normal((7, 9)),
                    "pid": os.getpid()}

        def echo(self, value):
            return value, os.getpid()

    a, b = Holder.remote(), Holder.remote()
    made = cluster.get(a.make.remote(3))
    echoed, pid = cluster.get(b.echo.remote(a.make.remote(3)))
    assert made["pid"] != pid != os.getpid()
    g = torch.Generator().manual_seed(3)
    want = {"f32": torch.randn(33, 17, generator=g),
            "bf16": torch.randn(8, 64, generator=g).to(torch.bfloat16),
            "leaf": torch.randn(5, generator=g)}
    bits = lambda t: t.detach().reshape(-1).view(torch.uint8)  # noqa: E731
    for got in (made, echoed):
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            assert torch.equal(bits(got[k]), bits(w)), k
        assert got["leaf"].requires_grad
        assert got["array"].tobytes() == np.random.default_rng(3).standard_normal(
            (7, 9)).tobytes()


def test_the_zygote_keeps_its_fork_contract(cluster):
    """After its preload the zygote runs one thread and has not initialised
    CUDA, so its forked workers can; the port's zygote has torch loaded
    (the JAX package's zygote reports no torch or CUDA state)."""
    import json
    import socket

    node_log_dir = importlib.import_module(
        f"{cluster.__name__}.util.profiling").node_log_dir

    @cluster.remote
    def touch():
        return os.getpid()

    cluster.get(touch.remote())   # at least one fork
    node_id = cluster.nodes()[0]["NodeID"]
    path = os.path.join(node_log_dir(node_id), "zygote-default.sock")
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(10)
        sock.connect(path)
        sock.sendall(b'{"op": "ping"}\n')
        reply = json.loads(sock.makefile().readline())
    assert reply["ok"] and reply["forks"] >= 1
    assert reply["threads"] == 1
    assert reply.get("cuda_initialized", False) is False
    if cluster.__name__ == "ray_tpu_torch":
        assert reply["torch_loaded"] is True
        # Nor the driver itself: a forked child's CUDA_VISIBLE_DEVICES
        # (its lease's cards) takes effect only before cuInit.
        assert reply["cuda_driver_initialized"] is False


_JOIN = r"""
import sys
sys.path.insert(0, %r)
import %s as rt
try:
    rt.init(address=%r)
except Exception as e:
    print("REFUSED", type(e).__name__, e)
    sys.exit(3)
print("JOINED", rt.get(rt.get_actor("joiner").ping.remote()),
      rt.get(rt.remote(lambda: 5).remote()))
rt.shutdown()
"""


def _driver(runtime: str, address: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "RAY_TPU_ADDRESS"}
    return subprocess.run(
        [sys.executable, "-c", _JOIN % (REPO, runtime, address)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)


def test_a_second_driver_joins_and_the_other_runtime_is_refused(cluster):
    @cluster.remote
    class Joiner:
        def ping(self):
            return "pong"

    actor = Joiner.options(name="joiner").remote()
    cluster.get(actor.ping.remote())
    address = cluster.api._worker.gcs_address
    same = _driver(cluster.__name__, address)
    assert same.returncode == 0, same.stdout + same.stderr
    assert "JOINED pong 5" in same.stdout
    other = _driver("ray_tpu" if cluster is ray_tpu_torch else "ray_tpu_torch",
                    address)
    assert other.returncode == 3, other.stdout + other.stderr
    assert ("is not a ray_tpu_torch head" if cluster is ray_tpu
            else "this head runs ray_tpu_torch") in other.stdout
    cluster.kill(actor)


def test_a_killed_owners_objects_are_freed(cluster):
    """A SIGKILLed worker owned a put object and the store-held return of
    a task it submitted: the port's daemon frees both, so the store's
    (used bytes, objects) return to the baseline, and a borrower's `get`
    raises OwnerDiedError at once. JAX's run prints what its store keeps
    and what the `get` gives; only the port's half is asserted."""

    @cluster.remote
    def payload(n):
        import numpy as np

        return np.ones(n, np.uint8)

    @cluster.remote
    class Owner:
        def make(self, n):
            put = cluster.put(np.ones(n, np.uint8))
            ret = payload.remote(n)
            cluster.wait([ret], num_returns=1, timeout=60)
            return [put, ret], os.getpid()

    store = cluster.api._global_worker().store
    baseline = (store.used, store.num_objects)
    owner = Owner.remote()
    (put, ret), pid = cluster.get(owner.make.remote(1_000_000), timeout=60)
    held = (store.used, store.num_objects)
    os.kill(pid, 9)
    # JAX's daemon frees nothing of a dead owner: no wait for its store.
    deadline = time.monotonic() + (20 if cluster is ray_tpu_torch else 0)
    while ((store.used, store.num_objects) != baseline
           and time.monotonic() < deadline):
        time.sleep(0.1)
    after = (store.used, store.num_objects)
    t0 = time.monotonic()
    try:
        got = type(cluster.get(put, timeout=20)).__name__
    except Exception as e:  # noqa: BLE001 what each runtime raises
        got = type(e).__name__
    waited = time.monotonic() - t0
    print(f"{cluster.__name__}: store (used, objects) {baseline} before, "
          f"{held} with the owner, {after} after its SIGKILL; get of its "
          f"put gave {got} in {waited:.2f} s")
    if cluster is ray_tpu_torch:
        assert held[0] >= baseline[0] + 2_000_000, (baseline, held)
        assert after == baseline, (baseline, held, after)
        assert got == "OwnerDiedError", got
        assert waited < 15, waited
        with pytest.raises(ray_tpu_torch.exceptions.OwnerDiedError):
            cluster.get(ret, timeout=20)
