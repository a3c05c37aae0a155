"""Live-camera plug-in point for the FrameSource interface (port of
`rt3d/io/live.py`; numpy only).

The reference's capture layer is the ZED SDK (`pyzed.sl` — C++/CUDA, USB3
stereo cameras; open/grab/retrieve loop at `2cam/2cams_mask_gpu.py:62-96,
179-215`). Live capture is a plug-in: implement `grab()` against any camera
SDK and the rest of the port (pipeline, driver, CSVs, viz) works unchanged.
`CallbackSource` adapts any frame-producing callable; `zed_sdk_source`
adapts opened ZED cameras, the SDK module passed in by the caller (so
nothing here imports it).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from rt3d_torch.config import CameraConfig, Intrinsics
from rt3d_torch.io.source import FramePacket


class CallbackSource:
    """FrameSource over a user callback.

    grab(index) -> (rgb (C,H,W,3) u8 BGR, depth (C,H,W) f32, status (C,) u32)
    """

    def __init__(
        self,
        grab: Callable[[int], Tuple[np.ndarray, np.ndarray, np.ndarray]],
        cameras: List[CameraConfig],
        hw: Tuple[int, int],
        num_frames: Optional[int] = None,
    ):
        self._grab = grab
        self._cams = cameras
        self._hw = hw
        self._n = num_frames

    @property
    def num_cameras(self) -> int:
        return len(self._cams)

    @property
    def num_frames(self) -> Optional[int]:
        return self._n

    @property
    def frame_hw(self) -> Tuple[int, int]:
        return self._hw

    def cameras(self) -> List[CameraConfig]:
        return list(self._cams)

    def get(self, index: int) -> FramePacket:
        rgb, depth, status = self._grab(index)
        return FramePacket(rgb=rgb, depth=depth,
                           status=np.asarray(status, np.uint32), index=index)

    def close(self) -> None:
        pass


def zed_sdk_source(
    sl,
    sdk_cams,
    hw: Tuple[int, int] = (720, 1280),
    cameras: Optional[List[CameraConfig]] = None,
    num_frames: Optional[int] = None,
) -> CallbackSource:
    """Adapt opened `pyzed.sl`-shaped Camera objects into a FrameSource,
    written against the SDK *surface* the reference uses
    (`2cam/2cams_mask_gpu.py:62-96, 179-215`) so a real `pyzed.sl` module
    drops in unchanged:

    - ``sl``: the SDK module. Needs ``Mat()`` (with ``.get_data()``),
      ``VIEW.LEFT``, ``MEASURE.DEPTH``, and ``ERROR_CODE.SUCCESS``.
    - ``sdk_cams``: opened Camera-shaped objects: ``grab()`` returning a
      status comparable to ``ERROR_CODE.SUCCESS``, ``retrieve_image(mat,
      view)`` / ``retrieve_measure(mat, measure)`` filling the Mat, and
      ``get_camera_information()`` exposing
      ``.camera_configuration.calibration_parameters.left_cam.{fx,fy,cx,cy}``.

    ZED images arrive BGRA — the alpha channel is stripped; depth maps
    carry NaN/inf at invalid pixels — mapped to 0, which the pipeline's
    ``depth_min_m`` gate rejects like the reference's ``np.isfinite``
    filtering (`2cam/vision_pipeline_utils.py:22-31`); a failed ``grab()``
    yields a zero frame with per-camera status 1, which the driver skips
    like the reference's `if err != SUCCESS: continue`
    (`2cam/2cams_mask_gpu.py:179-186`). Extrinsics stay caller-provided
    (the reference composes chessboard calibration host-side,
    `2cams.py:100-124`); intrinsics default to the SDK's factory values.
    """
    ok = sl.ERROR_CODE.SUCCESS
    mats_i = [sl.Mat() for _ in sdk_cams]
    mats_d = [sl.Mat() for _ in sdk_cams]

    if cameras is None:
        cameras = []
        for i, cam in enumerate(sdk_cams):
            p = (cam.get_camera_information()
                 .camera_configuration.calibration_parameters.left_cam)
            cameras.append(CameraConfig(
                name=f"zed{i}",
                intrinsics=Intrinsics(fx=float(p.fx), fy=float(p.fy),
                                      cx=float(p.cx), cy=float(p.cy),
                                      width=hw[1], height=hw[0])))

    def grab(index: int):
        rgbs, depths, stats = [], [], []
        for c, cam in enumerate(sdk_cams):
            if cam.grab() == ok:
                cam.retrieve_image(mats_i[c], sl.VIEW.LEFT)
                cam.retrieve_measure(mats_d[c], sl.MEASURE.DEPTH)
                img = np.asarray(mats_i[c].get_data())
                if img.shape[-1] == 4:      # ZED serves BGRA
                    img = np.ascontiguousarray(img[..., :3])
                dep = np.nan_to_num(np.asarray(mats_d[c].get_data(), np.float32),
                                    nan=0.0, posinf=0.0, neginf=0.0)
                stats.append(0)
            else:
                img = np.zeros((*hw, 3), np.uint8)
                dep = np.zeros(hw, np.float32)
                stats.append(1)             # frame-skip status
            rgbs.append(img)
            depths.append(dep)
        return np.stack(rgbs), np.stack(depths), np.asarray(stats, np.uint32)

    return CallbackSource(grab, cameras, hw, num_frames=num_frames)
