"""The .rts recorded-sequence container (rt3d sequence, version 1); a
numpy-only copy of `rt3d/io/format.py`, which the port may not import.

A single file holds synchronized multi-camera RGB + depth with calibration,
laid out for O(1) mmap'd random access — the replay analog of what the ZED
SDK produces live (`retrieve_image` + `retrieve_measure(DEPTH)`,
`2cam/vision_pipeline_utils.py:190-227`).

Layout (little-endian):
  [0:4)    magic  b"RTS1"
  [4:8)    u32 version = 1
  [8:12)   u32 n_cams
  [12:16)  u32 n_frames
  [16:20)  u32 height
  [20:24)  u32 width
  [24:28)  u32 flags (bit 0: has_depth; others reserved)
  [28:32)  u32 meta_len (JSON bytes)
  [32:32+meta_len)  UTF-8 JSON: per-camera intrinsics/extrinsics, fps, notes
  [data_off:...)    frame records, frame-major then camera-major:
      status  u32   (0 = OK; mirrors the ZED error-code-per-frame semantics,
                     `2cams.py:174-176`)
      rgb     H*W*3 u8  (BGR, matching the reference's cv2 frames)
      depth   H*W   f32 (meters; NaN/Inf/0 = invalid, ZED conventions)

The C++ replayer (native/replayer.cpp, bound by `rt3d_torch.io.native`) and
the NumPy memmap reader both consume this layout; the recorder below
produces it.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

MAGIC = b"RTS1"
VERSION = 1
HEADER_FMT = "<4s7I"
HEADER_SIZE = struct.calcsize(HEADER_FMT)  # 32 bytes


@dataclass(frozen=True)
class SequenceSpec:
    n_cams: int
    n_frames: int
    height: int
    width: int
    has_depth: bool
    meta: dict
    data_offset: int

    @property
    def rec_status_size(self) -> int:
        return 4

    @property
    def rgb_size(self) -> int:
        return self.height * self.width * 3

    @property
    def depth_size(self) -> int:
        return self.height * self.width * 4 if self.has_depth else 0

    @property
    def cam_record_size(self) -> int:
        return self.rec_status_size + self.rgb_size + self.depth_size

    @property
    def frame_record_size(self) -> int:
        return self.cam_record_size * self.n_cams

    def cam_offset(self, frame: int, cam: int) -> int:
        return (
            self.data_offset
            + frame * self.frame_record_size
            + cam * self.cam_record_size
        )


def read_header(path: str) -> SequenceSpec:
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
        magic, version, n_cams, n_frames, h, w, flags, meta_len = struct.unpack(
            HEADER_FMT, head
        )
        if magic != MAGIC:
            raise ValueError(f"{path}: not an RTS file (magic={magic!r})")
        if version != VERSION:
            raise ValueError(f"{path}: unsupported RTS version {version}")
        meta = json.loads(f.read(meta_len).decode("utf-8")) if meta_len else {}
    return SequenceSpec(
        n_cams=n_cams, n_frames=n_frames, height=h, width=w,
        has_depth=bool(flags & 1), meta=meta,
        data_offset=HEADER_SIZE + meta_len,
    )


def write_sequence(
    path: str,
    rgb: np.ndarray,                 # (F, C, H, W, 3) u8
    depth: Optional[np.ndarray],     # (F, C, H, W) f32 or None
    meta: dict,
    status: Optional[np.ndarray] = None,  # (F, C) u32
) -> SequenceSpec:
    """Record a sequence (the offline counterpart of live ZED capture)."""
    f_, c_, h, w, _ = rgb.shape
    assert rgb.dtype == np.uint8
    has_depth = depth is not None
    if has_depth:
        assert depth.shape == (f_, c_, h, w) and depth.dtype == np.float32
    if status is None:
        status = np.zeros((f_, c_), np.uint32)
    meta_bytes = json.dumps(meta).encode("utf-8")
    flags = 1 if has_depth else 0
    with open(path, "wb") as f:
        f.write(struct.pack(HEADER_FMT, MAGIC, VERSION, c_, f_, h, w, flags,
                            len(meta_bytes)))
        f.write(meta_bytes)
        for fi in range(f_):
            for ci in range(c_):
                f.write(np.uint32(status[fi, ci]).tobytes())
                f.write(np.ascontiguousarray(rgb[fi, ci]).tobytes())
                if has_depth:
                    f.write(np.ascontiguousarray(depth[fi, ci]).tobytes())
    return read_header(path)


def camera_meta(
    fx: float, fy: float, cx: float, cy: float,
    rotation: List[List[float]], translation: List[float],
    serial: Optional[int] = None, fps: int = 30,
) -> dict:
    return {
        "intrinsics": {"fx": fx, "fy": fy, "cx": cx, "cy": cy},
        "extrinsics": {"rotation": rotation, "translation": translation},
        "serial": serial,
        "fps": fps,
    }
