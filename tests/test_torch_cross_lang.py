"""Cross-language calls of ray_tpu_torch against ray_tpu's, on the CPU.

The C++ worker and client examples of `cpp/` are compiled by g++ from the
unedited sources into the port's own build directory
(`ray_tpu_torch/_build/cpp/`, so no other test file writes the same
binary), once for this file. The cases of tests/test_cpp_worker.py run
through both packages' `util.cross_lang.CppWorker` on that worker binary
and must give the same values, error types and messages. The case of
tests/test_cpp_client.py runs the client binary against a cluster of each
runtime in turn, whose `register_cross_lang` names the Python functions
the C++ side calls: the port's Python workers run them.
"""
import gc
import importlib
import os
import shutil
import subprocess
import tempfile
import time

import pytest

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "ray_tpu_torch", "_build", "cpp")
INC = os.path.join(REPO, "cpp", "include")
RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]


def _cross_lang(rt):
    return importlib.import_module(f"{rt.__name__}.util.cross_lang")


def _build(name: str, extra=()) -> str:
    """Compile cpp/examples/<name>.cc into BUILD, unless a binary newer
    than its sources is there; written to a temporary name, then renamed."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no C++ toolchain (g++) to build the cpp/ examples")
    os.makedirs(BUILD, exist_ok=True)
    out = os.path.join(BUILD, name)
    src = os.path.join(REPO, "cpp", "examples", f"{name}.cc")
    deps = [src, os.path.join(INC, "ray_tpu_worker", "ray_tpu_worker.hpp"),
            os.path.join(INC, "ray_tpu_client", "ray_tpu_client.hpp")]
    if os.path.exists(out) and os.path.getmtime(out) >= max(map(os.path.getmtime, deps)):
        return out
    fd, tmp = tempfile.mkstemp(dir=BUILD, prefix=f".{name}.")
    os.close(fd)
    try:
        subprocess.run([gxx, "-std=c++17", "-O2", *extra, f"-I{INC}", src, "-o", tmp],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@pytest.fixture(scope="module")
def worker_binary():
    return _build("worker_example", ("-pthread",))


@pytest.fixture(scope="module")
def workers(worker_binary):
    """One CppWorker of each package on the same binary."""
    ws = [_cross_lang(rt).CppWorker(worker_binary) for rt in RUNTIMES]
    try:
        yield ws
    finally:
        for w in ws:
            w.close()


def _outcome(fn):
    """The value, or the error's (type name, message)."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the case reports it
        return type(e).__name__, str(e)


# -- the cases of tests/test_cpp_worker.py --------------------------------------

def w_registry_and_ping(w):
    return w.ping(), w.functions()


def w_invoke_scalars_and_structures(w):
    return (w.invoke("Add", 2.0, 3.5), w.invoke("Add", 2, 3),
            w.invoke("Dot", [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]),
            w.invoke("Describe", [1.0, 2.0, 3.0, 4.0]))


def w_cpp_error_surfaces_as_python_exception(w):
    return _outcome(lambda: w.invoke("Boom")), _outcome(lambda: w.invoke("NoSuchFn"))


def w_concurrent_submissions(w):
    futs = [w.submit("Add", i, i) for i in range(32)]
    return [f.result(timeout=60) for f in futs]


def w_actor_create_call_state_kill(w):
    types = w.actor_types()
    h = w.create_actor("Counter", 10)
    got = [h.call("Inc", 5), h.call("Inc"), h.call("Get")]
    h.kill()
    return types, got, _outcome(lambda: h.call("Get")), _outcome(h.kill)


def w_actor_ordered_async_dispatch(w):
    h = w.create_actor("Counter")
    seen = [f.result(timeout=60) for f in [h.submit("Inc", 1) for _ in range(64)]]
    final = h.call("Get")
    h.kill()
    return seen, final


def w_actor_blocking_call_observes_prior_submissions(w):
    h = w.create_actor("Counter")
    for _ in range(16):
        h.submit("Inc", 1)
    got = h.call("Get")
    h.kill()
    return got


def w_actor_dies_when_handle_dropped(w):
    h = w.create_actor("Counter", 5)
    actor_id = h.actor_id
    first = h.call("Get")
    del h
    gc.collect()
    deadline = time.time() + 10
    while time.time() < deadline:
        reply = w._client.call("CppWorker", "call_actor", timeout=10,
                               actor_id=actor_id, name="Get", args=[])
        if not reply.get("ok"):
            break
        time.sleep(0.1)
    return first, "no such C++ actor" in reply.get("error", "")


def w_actor_instances_are_independent(w):
    a = w.create_actor("Counter", 100)
    b = w.create_actor("Counter", 200)
    distinct = a.actor_id != b.actor_id
    a.call("Inc", 1)
    got = [a.call("Get"), b.call("Get")]
    a.kill()
    got.append(b.call("Get"))
    b.kill()
    return distinct, got


def w_actor_errors_propagate_and_do_not_kill(w):
    h = w.create_actor("Counter", 7)
    got = [_outcome(lambda: h.call("Fail")), h.call("Get"),
           _outcome(lambda: h.call("NoSuchMethod"))]
    h.kill()
    got += [_outcome(lambda: w.create_actor("Counter", -5)),
            _outcome(lambda: w.create_actor("NoSuchType"))]
    return got


WORKER = {"registry_and_ping": (w_registry_and_ping, (True, ["Add", "Boom", "Describe", "Dot"])),
          "invoke_scalars_and_structures": (
              w_invoke_scalars_and_structures, (5.5, 5.0, 32.0, {"sum": 10.0, "n": 4})),
          "cpp_error_surfaces_as_python_exception": (
              w_cpp_error_surfaces_as_python_exception, None),
          "concurrent_submissions": (w_concurrent_submissions, [2.0 * i for i in range(32)]),
          "actor_create_call_state_kill": (w_actor_create_call_state_kill, None),
          "actor_ordered_async_dispatch": (
              w_actor_ordered_async_dispatch, (list(range(1, 65)), 64)),
          "actor_blocking_call_observes_prior_submissions": (
              w_actor_blocking_call_observes_prior_submissions, 16),
          "actor_dies_when_handle_dropped": (w_actor_dies_when_handle_dropped, (5, True)),
          "actor_instances_are_independent": (
              w_actor_instances_are_independent, (True, [101, 200, 200])),
          "actor_errors_propagate_and_do_not_kill": (
              w_actor_errors_propagate_and_do_not_kill, None)}


@pytest.mark.parametrize("name", list(WORKER))
def test_cpp_worker_matches_jax(workers, name):
    case, want = WORKER[name]
    got = [case(w) for w in workers]
    assert got[0] == got[1], got
    if want is not None:
        assert got[1] == want, got[1]


def test_cpp_error_names_match_the_reference_cases(workers):
    """The messages tests/test_cpp_worker.py matches, through the port."""
    w = workers[1]
    err = _cross_lang(ray_tpu_torch).CppFunctionError
    for call, pattern in ((lambda: w.invoke("Boom"), "boom from C\\+\\+"),
                          (lambda: w.invoke("NoSuchFn"), "no registered"),
                          (lambda: w.create_actor("Counter", -5), "constructor raised"),
                          (lambda: w.create_actor("NoSuchType"),
                           "no registered C\\+\\+ actor type")):
        with pytest.raises(err, match=pattern):
            call()


@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_worker_dies_with_owner(worker_binary, rt):
    w = _cross_lang(rt).CppWorker(worker_binary)
    pid = w._proc.pid
    assert w.invoke("Add", 1, 1) == 2.0
    w.close()
    assert w._proc.poll() is not None
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


# -- the case of tests/test_cpp_client.py ---------------------------------------

@pytest.mark.parametrize("rt", RUNTIMES, ids=IDS)
def test_cpp_client_end_to_end(rt):
    """The client binary puts and reads a KV entry, then submits tasks that
    run `cpp_add` and `cpp_describe`, which `register_cross_lang` named, on
    the runtime's Python workers."""
    binary = _build("client_example")
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()
    rt.init(num_cpus=4)
    try:
        def cpp_add(a, b):
            return a + b

        def cpp_describe(spec):
            return {"total": float(sum(spec["xs"])), "label": spec["label"] + "!"}

        rt.register_cross_lang("cpp_add", cpp_add)
        rt.register_cross_lang("cpp_describe", cpp_describe)
        address = rt.api._global_worker().gcs_address
        out = subprocess.run([binary, address], capture_output=True, text=True,
                             timeout=180)
    finally:
        rt.shutdown()
    assert out.returncode == 0, out.stdout + out.stderr
    for line in ("KV: hello from c++", "TASK_RESULT: 42", "STRUCTURED_TOTAL: 4.0",
                 "CPP_CLIENT_OK"):
        assert line in out.stdout, out.stdout
