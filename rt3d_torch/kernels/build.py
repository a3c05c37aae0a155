"""Build and load the hand-written CUDA kernels of `rt3d_torch/csrc/`.

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles each source
for ``sm_90a`` into an object; one more links them into a shared library
with a plain C interface, which is loaded with `ctypes`. No source includes
a PyTorch header, so a build from clean takes seconds. The library lands in
``build/rt3d_torch/`` at the repository root, keyed by a hash of the
sources and flags, so an unchanged tree reuses it.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rt3d_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (argtypes); every one returns cudaGetLastError() as int
_SIGNATURES = {
    "rt3d_window_dedupe": (_P, _P, _I, _I, _I, _I, ctypes.c_int32, _P),
    "rt3d_window_prev_or": (_P, _P, _P, _I, _I, _I, _I, ctypes.c_int32, _P),
    "rt3d_sor_knn_slots": (_P, _P, _P, _P, _I, _I, _I, _P),
    "rt3d_sor_knn": (_P, _P, _P, _P, _I, _I, _P),
    "rt3d_min_sqdist": (_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _P),
    "rt3d_greedy_match": (_P, _I, _I, ctypes.c_float, _P, _P, _P),
    "rt3d_sam_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P),
    "rt3d_noop": (_P,),
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


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    return proc.stdout


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the kernels unless a library for these sources exists.
    Returns (library path, build seconds (0 when reused), nvcc output)."""
    out = library_path()
    if out.exists():
        log = out.with_suffix(".log")
        return out, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, f"{src.stem}.o") for src in sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(sources(), objs)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(cmds)) as pool:
            log = "".join(pool.map(_run, cmds))
        lib = os.path.join(work, "lib.so")
        log += _run([nvcc, "-shared", "-o", lib, *objs])
        secs = time.perf_counter() - t0
        os.replace(lib, out)
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
