"""The frozen traffic equals the port's easy-domain source bit for bit."""

import numpy as np
import pytest

from bench_port.synthetic import EasyScene, cycle, ping_pong


@pytest.mark.parametrize("seed", [20260, 2**31 + 17])
def test_frames_equal_the_ports_source(seed):
    from rt3d_torch.io import SyntheticSource

    src = SyntheticSource(num_cameras=2, num_frames=None, hw=(720, 1280), num_objects=6,
                          seed=seed)
    scene = EasyScene(2, 6, seed, (720, 1280))
    for i in (0, 13, 31):
        rgb, depth = scene.render(i)
        pkt = src.get(i)
        assert rgb.dtype == np.uint8 and depth.dtype == np.float32
        assert np.array_equal(rgb, pkt.rgb)
        assert np.array_equal(depth, pkt.depth, equal_nan=True)
    for got, cam in zip(scene.cameras(), src.cameras()):
        assert got["intrinsics"]["fx"] == cam.intrinsics.fx
        assert np.array_equal(np.asarray(got["rotation"], np.float32), cam.extrinsics.R)
        assert np.array_equal(np.asarray(got["translation"], np.float32), cam.extrinsics.t)


def test_ping_pong():
    assert [ping_pong(g, 4) for g in range(9)] == [0, 1, 2, 3, 2, 1, 0, 1, 2]
    assert cycle(32) == 62 and ping_pong(61, 32) == 1 and ping_pong(62, 32) == 0
