"""The FrameSource interface and recorded-sequence replay (port of
`rt3d/io/source.py`; numpy only).

The interface mirrors what the reference's hot loop needs from the ZED SDK
each iteration: synchronized per-camera RGB frames and depth maps plus a
per-frame status code (`2cam/vision_pipeline_utils.py:190-227`, error-skip
semantics at `2cams.py:174-176`), with calibration available up front
(`2cams.py:90-124`).

`ReplaySource` prefers the C++ mmap replayer (`rt3d_torch.io.native`, built
from `native/replayer.cpp`) and falls back to NumPy memmap views when it
cannot be built or opened; `backend` says which one serves the frames.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import List, Optional, Protocol, Tuple

import numpy as np

from rt3d_torch.config import CameraConfig, Extrinsics, Intrinsics
from rt3d_torch.io.format import SequenceSpec, read_header


@dataclass
class FramePacket:
    """One synchronized multi-camera frame."""

    rgb: np.ndarray     # (C, H, W, 3) u8 BGR
    depth: np.ndarray   # (C, H, W) f32 meters
    status: np.ndarray  # (C,) u32, 0 = OK
    index: int


class FrameSource(Protocol):
    """Anything that can feed the pipeline frames."""

    @property
    def num_cameras(self) -> int: ...

    @property
    def num_frames(self) -> Optional[int]: ...

    @property
    def frame_hw(self) -> Tuple[int, int]: ...

    def cameras(self) -> List[CameraConfig]: ...

    def get(self, index: int) -> FramePacket: ...

    def close(self) -> None: ...


def _cameras_from_meta(meta: dict) -> List[CameraConfig]:
    cams = []
    for i, c in enumerate(meta.get("cameras", [])):
        intr = c["intrinsics"]
        extr = c["extrinsics"]
        cams.append(CameraConfig(
            name=f"cam{i + 1}",
            intrinsics=Intrinsics(
                fx=intr["fx"], fy=intr["fy"], cx=intr["cx"], cy=intr["cy"],
                width=meta.get("width", 1280), height=meta.get("height", 720)),
            extrinsics=Extrinsics(
                rotation=tuple(tuple(r) for r in extr["rotation"]),
                translation=tuple(extr["translation"])),
            serial=c.get("serial"),
            fps=c.get("fps", 30)))
    return cams


class ReplaySource:
    """Recorded-sequence playback from an .rts file (mmap, O(1) seek).
    With ``loop=True`` an index wraps modulo the frame count; otherwise an
    index outside the sequence raises `IndexError`."""

    def __init__(self, path: str, use_native: bool = True, loop: bool = False):
        self.path = path
        self.spec: SequenceSpec = read_header(path)
        self.loop = loop
        self._native = None
        if use_native:
            from rt3d_torch.io.native import NativeReplayer

            try:
                self._native = NativeReplayer(path, self.spec)
            except (OSError, RuntimeError, subprocess.CalledProcessError):
                self._native = None  # no g++ or no mapping: numpy memmap serves
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")

    # -- FrameSource ------------------------------------------------------

    @property
    def num_cameras(self) -> int:
        return self.spec.n_cams

    @property
    def num_frames(self) -> Optional[int]:
        return self.spec.n_frames

    @property
    def frame_hw(self) -> Tuple[int, int]:
        return (self.spec.height, self.spec.width)

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "memmap"

    def cameras(self) -> List[CameraConfig]:
        meta = dict(self.spec.meta)
        meta.setdefault("width", self.spec.width)
        meta.setdefault("height", self.spec.height)
        return _cameras_from_meta(meta)

    def get(self, index: int) -> FramePacket:
        n = self.spec.n_frames
        if self.loop:
            index = index % n
        if not (0 <= index < n):
            raise IndexError(f"frame {index} out of range [0, {n})")
        if self._native is not None:
            rgb, depth, status = self._native.frame(index)
            return FramePacket(rgb=rgb, depth=depth, status=status, index=index)

        s = self.spec
        h, w, c = s.height, s.width, s.n_cams
        rgbs, depths, stats = [], [], []
        for ci in range(c):
            off = s.cam_offset(index, ci)
            stats.append(self._mm[off:off + 4].view(np.uint32)[0])
            off += 4
            rgbs.append(self._mm[off:off + s.rgb_size].reshape(h, w, 3))
            off += s.rgb_size
            if s.has_depth:
                depths.append(self._mm[off:off + s.depth_size].view(np.float32).reshape(h, w))
            else:
                depths.append(np.zeros((h, w), np.float32))
        return FramePacket(rgb=np.stack(rgbs), depth=np.stack(depths),
                           status=np.asarray(stats, np.uint32), index=index)

    def close(self) -> None:
        """Join the native replayer's prefetch thread and drop the mapping."""
        if self._native is not None:
            self._native.close()
            self._native = None
        self._mm = None
