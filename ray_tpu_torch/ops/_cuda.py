"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `_build/lib<name>.so` at
first use, and again when the source is newer than the library. The
sources have a plain C interface, so the build needs no PyTorch headers
and takes seconds. Every pointer and the stream cross as `c_void_p`.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import re
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found: ray_tpu_torch builds its CUDA kernels from "
        f"{CSRC_DIR} at first use and needs the CUDA toolkit "
        "(PATH, CUDA_HOME or /usr/local/cuda)")


def library_path(name: str) -> str:
    """Build csrc/<name>.cu if the library is missing or stale; return it.

    Safe across processes: builds serialize on a file lock and publish
    the library with an atomic rename. nvcc's report (registers, shared
    memory and spills per kernel) is kept beside it as lib<name>.log.
    """
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")

    def fresh() -> bool:
        return (os.path.exists(lib)
                and os.path.getmtime(lib) >= os.path.getmtime(src))

    if fresh():
        return lib
    find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not fresh():
                compile_library(src, lib)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return lib


def compile_library(src: str, lib: str) -> None:
    """nvcc `src` into the shared library `lib`, published by atomic rename;
    nvcc's report goes to `lib` with .so replaced by .log."""
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.splitext(lib)[0] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_MANGLED = re.compile(r"(_Z\w+)")


def kernel_label(mangled: str) -> str:
    """`fa_fwd_wgmma_kernel<64>`, `fa_bwd_dq_kernel<bf16, 64>` and the like
    from a mangled kernel name of flash_attention.cu."""
    m = re.search(r"(fa_\w+?_kernel)I(f|13__nv_bfloat16)?Li(\d+)E", mangled)
    if not m:
        return mangled
    dtype = {"f": "float", "13__nv_bfloat16": "bf16", None: None}[m.group(2)]
    return f"{m.group(1)}<{', '.join(a for a in (dtype, m.group(3)) if a)}>"


def ptxas_report(log: str) -> dict[str, dict]:
    """Each kernel's entry in nvcc's `-Xptxas -v` report (the text of a
    lib<name>.log): registers, stack and spill bytes, static shared memory,
    and every report line about it that mentions wgmma or setmaxnreg (a
    serialised wgmma pipeline, an ignored setmaxnreg)."""
    kernels: dict[str, dict] = {}

    def record(mangled: str) -> dict:
        return kernels.setdefault(kernel_label(mangled), {
            "registers": None, "stack_bytes": 0, "spill_store_bytes": 0,
            "spill_load_bytes": 0, "static_smem_bytes": 0, "notes": []})

    current = None
    for line in log.splitlines():
        entry = _ENTRY.search(line)
        if entry:
            current = record(entry.group(1))
            continue
        said = _MANGLED.sub("", line)  # kernel names may hold "wgmma"
        if "wgmma" in said or "setmaxnreg" in said:
            named = _MANGLED.search(line)
            target = record(named.group(1)) if named else current
            if target is not None:
                target["notes"].append(line.strip())
            continue
        if current is None:
            continue
        spills = _SPILLS.search(line)
        if spills:
            current["stack_bytes"], current["spill_store_bytes"], \
                current["spill_load_bytes"] = map(int, spills.groups())
        used = _USED.search(line)
        if used:
            current["registers"] = int(used.group(1))
            smem = _SMEM.search(line)
            current["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return kernels


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(library_path(name))
        return _loaded[name]


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
