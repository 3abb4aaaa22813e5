"""Build-on-first-use for the port's native C++ host libraries.

The port's copy of gtsfm_tpu/native/build.py. The host-side sequential
algorithms (DSF track linking, MFAS ordering) live in small C++ shared
objects built from the sources in this directory. ensure_built() compiles a
missing or stale .so once with g++ into ``build/torch_native/`` at the root
of the checkout (git-ignored), never into the reference package, guarded by
an exclusive lock file so that concurrent test workers don't race. Callers
fall back to their numpy implementations when no toolchain is available.

These are CPU libraries, not device kernels.
"""

from __future__ import annotations

import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "torch_native")
_SOURCES = {
    "libdsf.so": "dsf.cpp",
    "libmfas.so": "mfas.cpp",
}


def ensure_built(so_name: str) -> str | None:
    """Return the absolute path of the shared object, compiling it from its
    C++ source if missing or older than the source. None when it cannot be
    built."""
    so_path = os.path.join(BUILD_DIR, so_name)
    src = _SOURCES.get(so_name)
    if src is None:
        raise ValueError(f"unknown native library {so_name}")
    src_path = os.path.join(_DIR, src)

    def _fresh() -> bool:
        return os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(src_path)

    if _fresh():
        return so_path
    try:
        import fcntl

        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(so_path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _fresh():  # re-check under the lock
                tmp = f"{so_path}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-fPIC", "-std=c++17", "-pthread",
                     "-shared", "-o", tmp, src_path],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so_path)  # atomic: readers never see partial
        return so_path
    except Exception:
        return so_path if os.path.exists(so_path) else None
