"""ctypes binding for the C++ mmap replayer (`native/replayer.cpp`), the
port's counterpart of `rt3d/io/native.py`.

The shared library is built on first use with ``g++`` from the checkout's
`native/replayer.cpp` into the gitignored ``build/rt3d_torch/``, keyed by a
hash of the source and flags as `rt3d_torch.kernels.build` keys the CUDA
kernels; nothing is written under `native/`. Frames are read through
NumPy views into the mapping and stacked into one array each; a C++
prefetch thread keeps the next frames paged in, and `NativeReplayer.close`
joins it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

from rt3d_torch.io.format import SequenceSpec

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "replayer.cpp"
BUILD_DIR = ROOT / "build" / "rt3d_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"librt3d_replayer_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the replayer unless a library for this source exists.
    Returns its path; raises `subprocess.CalledProcessError` (with g++'s
    output) or `OSError` (no g++) when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # atomic: concurrent builders each land a whole file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    lib.rts_open.restype = ctypes.c_void_p
    lib.rts_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rts_info.restype = None
    lib.rts_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)]
    lib.rts_frame.restype = ctypes.c_int
    lib.rts_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.rts_close.restype = None
    lib.rts_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeReplayer:
    """One open `.rts` file in the C++ replayer, with its prefetch thread."""

    def __init__(self, path: str, spec: SequenceSpec, prefetch_frames: int = 4):
        self._h = None
        lib = _load()
        self._lib = lib
        self._spec = spec
        self._h = lib.rts_open(path.encode(), prefetch_frames)
        if not self._h:
            raise RuntimeError(f"native replayer failed to open {path}")
        info = (ctypes.c_uint32 * 5)()
        lib.rts_info(self._h, info)
        if (info[0], info[1], info[2], info[3]) != (
                spec.n_cams, spec.n_frames, spec.height, spec.width):
            self.close()
            raise RuntimeError(f"{path}: native and Python headers disagree")

    def frame(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rgb (C, H, W, 3) u8, depth (C, H, W) f32, status (C,) u32) of
        frame `index`, copied out of the mapping by the stacking."""
        if not self._h:
            raise RuntimeError("native replayer is closed")
        s = self._spec
        h, w = s.height, s.width
        rgbs, depths, stats = [], [], []
        for cam in range(s.n_cams):
            p_status, p_rgb, p_depth = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
            rc = self._lib.rts_frame(self._h, index, cam, ctypes.byref(p_status),
                                     ctypes.byref(p_rgb), ctypes.byref(p_depth))
            if rc != 0:
                raise IndexError(f"frame {index} cam {cam} out of range")
            stats.append(np.ctypeslib.as_array(
                ctypes.cast(p_status, ctypes.POINTER(ctypes.c_uint32)), (1,))[0])
            rgbs.append(np.ctypeslib.as_array(
                ctypes.cast(p_rgb, ctypes.POINTER(ctypes.c_uint8)), (h, w, 3)))
            if s.has_depth and p_depth.value:
                depths.append(np.ctypeslib.as_array(
                    ctypes.cast(p_depth, ctypes.POINTER(ctypes.c_float)), (h, w)))
            else:
                depths.append(np.zeros((h, w), np.float32))
        return np.stack(rgbs), np.stack(depths), np.asarray(stats, np.uint32)

    def close(self) -> None:
        """Stop and join the prefetch thread, unmap the file."""
        if self._h:
            self._lib.rts_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
