"""Build and load the hand-written CUDA kernels of `rt3d_torch/csrc/`.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with `ctypes`. No source
includes a PyTorch header, so a build from clean takes seconds. The library
lands in ``build/rt3d_torch/`` at the repository root, keyed by a hash of
the sources and flags, so an unchanged tree reuses it.

Nothing here runs at import time: the first CUDA tensor that reaches a
kernel wrapper calls `load_library`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rt3d_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (argtypes); every one returns cudaGetLastError() as int
_SIGNATURES = {
    "rt3d_window_dedupe": (_P, _P, _I, _I, _I, _I, ctypes.c_int32, _P),
    "rt3d_window_prev_or": (_P, _P, _P, _I, _I, _I, _I, ctypes.c_int32, _P),
    "rt3d_sor_knn_slots": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rt3d_min_sqdist": (_P, _P, _P, _P, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of rt3d_torch are "
                       "built on a machine with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librt3d_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the kernels unless a library for these sources exists.
    Returns (library path, build seconds (0 when reused), nvcc output)."""
    out = library_path()
    if out.exists():
        log = out.with_suffix(".log")
        return out, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    return out, secs, log


@functools.cache
def load_library() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
