"""The frame container (numpy-only copy of `FramePacket` from
`rt3d/io/source.py`; recorded-sequence replay is not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FramePacket:
    """One synchronized multi-camera frame."""

    rgb: np.ndarray     # (C, H, W, 3) u8 BGR
    depth: np.ndarray   # (C, H, W) f32 meters
    status: np.ndarray  # (C,) u32, 0 = OK
    index: int
