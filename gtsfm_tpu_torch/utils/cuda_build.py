"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/torch_kernels/lib<name>.so`` (a plain C interface, no PyTorch
headers) and bound through ctypes. A library is rebuilt when its source is
newer. ``build`` starts one nvcc per source, all at once, and waits for
them; ``function`` builds one library on first use, keeps it loaded
and hands out one of its C functions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

_loaded: dict = {}
_lock = threading.Lock()


def sources() -> list:
    """Names of the kernels under csrc/ (``<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _up_to_date(name: str) -> bool:
    lib = library_path(name)
    return os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(source_path(name))


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named kernels (all of csrc/ by default) in parallel,
    skipping up-to-date libraries unless ``verbose``. Returns {name:
    compiler output} (register and shared-memory use with ``verbose``);
    raises if any nvcc fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if _up_to_date(name) and not verbose:
            continue
        tmp = library_path(name) + f".{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", tmp, source_path(name)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc exit {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of csrc/<name>.cu, returning an int
    (a cudaError_t), with its argument types bound: a pointer passed
    without ``c_void_p`` would be cut to 32 bits. The library is built on
    first use and kept loaded."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if not _up_to_date(name):
                build([name])
            lib = _loaded[name] = ctypes.CDLL(library_path(name))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
