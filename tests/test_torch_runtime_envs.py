"""pip, conda and container runtime envs: ray_tpu_torch against ray_tpu, on
the CPU.

The cases of tests/test_runtime_env.py:104-126 and
tests/test_runtime_env_plugins.py:88-131, through both runtimes: a pip env
installs a package from a local directory into a venv (nothing is
downloaded), a conda env runs on the python that a PATH-stubbed conda
creates, a container env wraps the worker command in a stubbed podman that
records its argv and runs the command (pip with conda is refused in
tests/test_torch_runtime_units.py). Each
runtime starts one single-node cluster for this file whose daemon sees the
stubs, never both at once. The port's venv worker also holds a GPU lease:
it is cold-started (a venv's python cannot fork from the zygote) with its
card in CUDA_VISIBLE_DEVICES, and imports torch and ray_tpu_torch.
"""
import glob
import importlib
import os
import stat
import sys
import textwrap

import pytest

import ray_tpu
import ray_tpu_torch

RUNTIMES = [ray_tpu, ray_tpu_torch]
IDS = ["ray_tpu", "ray_tpu_torch"]
ACCEL = {ray_tpu: "num_tpus", ray_tpu_torch: "num_gpus"}
RECORD = {}


def _agree(name, rt, got):
    """Record JAX's result; hold the port's to it."""
    if rt is ray_tpu:
        RECORD[name] = got
    elif name in RECORD:
        assert got == RECORD[name], (name, got, RECORD[name])
    return got


def _write_fake_tools(base: str) -> dict:
    """conda: `env create -p <dir> -f <spec>` makes <dir>/bin/python, a
    wrapper around this interpreter that marks its env; `run -n <name>`
    prints this interpreter. podman: records its argv, skips up to the
    image and runs the rest."""
    os.makedirs(base, exist_ok=True)
    conda = os.path.join(base, "conda")
    with open(conda, "w") as f:
        f.write(f"""#!/bin/bash
if [ "$1" = "env" ] && [ "$2" = "create" ]; then
    dir="$4"
    mkdir -p "$dir/bin"
    cat > "$dir/bin/python" <<PYEOF
#!/bin/bash
export CONDA_ENV_MARKER="$dir"
exec {sys.executable} "\\$@"
PYEOF
    chmod +x "$dir/bin/python"
    exit 0
fi
if [ "$1" = "run" ]; then
    echo "{sys.executable}"
    exit 0
fi
exit 1
""")
    record = os.path.join(base, "podman_args.txt")
    podman = os.path.join(base, "podman")
    with open(podman, "w") as f:
        f.write(f"""#!/bin/bash
echo "$@" >> {record}
while [ "$1" != "test-image:1" ] && [ -n "$1" ]; do shift; done
shift
exec "$@"
""")
    for path in (conda, podman):
        os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return {"RAY_TPU_CONDA_EXE": conda, "RAY_TPU_CONTAINER_RUNTIME": podman,
            "record": record}


@pytest.fixture(scope="module", params=RUNTIMES, ids=IDS)
def env_cluster(request, tmp_path_factory):
    rt = request.param
    # A JAX runtime left initialised by an earlier module of this worker
    # (ROADMAP C's init() leak) is shut down before this file starts one.
    for other in RUNTIMES:
        if other.is_initialized():
            other.shutdown()
    tools = _write_fake_tools(str(tmp_path_factory.mktemp("fake_tools")))
    env = {k: v for k, v in tools.items() if k.startswith("RAY_TPU")}
    c = importlib.import_module(f"{rt.__name__}.cluster_utils").Cluster(
        head_node_args={"num_cpus": 2, ACCEL[rt]: 1, "env": env})
    try:
        c.connect()
        yield rt, c, tools
    finally:
        c.shutdown()


def _env_root(rt, c):
    if rt is ray_tpu:
        return "/tmp/ray_tpu_runtime_envs"
    from ray_tpu_torch.core.distributed.runtime_env_agent import node_env_dir

    return node_env_dir(c.head.node_id)


def test_pip_env_installs_local_package(env_cluster, tmp_path):
    rt, _, _ = env_cluster
    pkg = tmp_path / "localdep"
    pkg.mkdir()
    (pkg / "setup.py").write_text(textwrap.dedent("""
        from setuptools import setup
        setup(name="rt_localdep", version="0.1",
              py_modules=["rt_localdep_mod"])
    """))
    (pkg / "rt_localdep_mod.py").write_text("ANSWER = 99\n")

    @rt.remote(runtime_env={"pip": [str(pkg)]}, **{ACCEL[rt]: 1})
    def use_dep():
        import sys as _sys

        import rt_localdep_mod

        torch_ok = rt.__name__ != "ray_tpu_torch" or bool(
            __import__("torch").__version__)
        return (rt_localdep_mod.ANSWER, "venv" in _sys.executable, torch_ok,
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    answer, in_venv, torch_ok, visible = rt.get(use_dep.remote(), timeout=300)
    _agree("pip", rt, (answer, in_venv, torch_ok))
    assert (answer, in_venv, torch_ok) == (99, True, True)
    if rt is ray_tpu_torch:
        assert visible == "0"
    with pytest.raises(ImportError):
        import rt_localdep_mod  # noqa: F401


def test_conda_spec_env_builds_and_caches(env_cluster):
    """An actor runs on a conda env the driver doesn't have; the second use
    is a cache hit (no rebuild)."""
    rt, c, _ = env_cluster

    spec = {"conda": {"name": "parity-env", "dependencies": ["python"]}}

    @rt.remote(runtime_env=spec)
    class CondaActor:
        def probe(self):
            return os.environ.get("CONDA_ENV_MARKER")

    a = CondaActor.remote()
    marker = rt.get(a.probe.remote(), timeout=120)
    rt.kill(a)
    # This spec's own cache entry (JAX's cache is shared by the host).
    renv = importlib.import_module(f"{rt.__name__}.runtime_env")
    key = renv.env_hash(renv.normalize(spec, lambda *a: None))
    ready = glob.glob(os.path.join(_env_root(rt, c), key, "CONDA_READY"))
    assert ready
    before = max(os.path.getmtime(p) for p in ready)
    b = CondaActor.remote()
    again = rt.get(b.probe.remote(), timeout=120)
    rt.kill(b)
    got = (bool(marker) and "conda" in marker, again == marker,
           max(os.path.getmtime(p) for p in ready) == before)
    assert _agree("conda", rt, got) == (True, True, True)


def test_container_wraps_worker_command(env_cluster):
    rt, _, tools = env_cluster

    @rt.remote(runtime_env={"container": {
        "image": "test-image:1", "run_options": ["--ipc=host"]}})
    def in_container():
        return "ran"

    ran = rt.get(in_container.remote(), timeout=120)
    argv = open(tools["record"]).read()
    got = (ran, "run --rm --network=host" in argv, "--ipc=host" in argv,
           "test-image:1" in argv, "-v /dev/shm:/dev/shm" in argv)
    assert _agree("container", rt, got) == ("ran", True, True, True, True)


def test_named_conda_env_runs_on_its_python(env_cluster):
    """A conda env given by name runs on the python `conda run -n <name>`
    reports (the stub reports this interpreter, so no env marker is set)."""
    rt, _, _ = env_cluster

    @rt.remote(runtime_env={"conda": "named-env"})
    def named():
        return os.environ.get("CONDA_ENV_MARKER")

    assert _agree("conda_named", rt, rt.get(named.remote(), timeout=120)) is None
