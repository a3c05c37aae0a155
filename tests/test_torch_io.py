"""The port's recorded-sequence IO (`rt3d_torch.io`: the `.rts` format, the
C++ replayer's binding and `ReplaySource`) against the JAX package's, on
the CPU, at 2 cameras of 48x64 and 4 frames.

Everything here is exact: the files are compared byte for byte, the frames
array for array (depth with its NaN in place), the cameras through
`to_dict`-style dicts.
"""

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest

from rt3d.io.format import camera_meta as jcamera_meta
from rt3d.io.format import write_sequence as jwrite_sequence
from rt3d.io.source import ReplaySource as JReplaySource
from rt3d_torch.io import ReplaySource, read_header, write_sequence
from rt3d_torch.io import native
from rt3d_torch.io.format import camera_meta

ROOT = Path(__file__).resolve().parents[1]
FRAMES, CAMS, H, W = 4, 2, 48, 64


def arrays():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (FRAMES, CAMS, H, W, 3), dtype=np.uint8)
    depth = rng.uniform(0.3, 3.0, (FRAMES, CAMS, H, W)).astype(np.float32)
    depth[0, 0, 0, 0] = np.nan
    status = np.zeros((FRAMES, CAMS), np.uint32)
    status[2, 1] = 7
    return rgb, depth, status


def meta(cm):
    return {"cameras": [
        cm(500.0 + i, 501.0, W / 2, H / 2, [[1, 0, 0], [0, -1, 0], [0, 0, -1]],
           [0.25 + 0.08 * i, 0.6, 1.0], serial=1000 + i, fps=30 + 30 * i)
        for i in range(CAMS)], "note": "test"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rts")
    rgb, depth, status = arrays()
    ours, theirs = str(d / "port.rts"), str(d / "jax.rts")
    write_sequence(ours, rgb, depth, meta(camera_meta), status)
    jwrite_sequence(theirs, rgb, depth, meta(jcamera_meta), status)
    return ours, theirs


def test_write_sequence_bytes_equal_jax(files):
    ours, theirs = files
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    spec = read_header(ours)
    assert (spec.n_cams, spec.n_frames, spec.height, spec.width, spec.has_depth) == (
        CAMS, FRAMES, H, W, True)


@pytest.mark.parametrize("backend", ["native", "memmap"])
def test_replay_frames_equal_jax(files, backend):
    ours, _ = files
    src = ReplaySource(ours, use_native=backend == "native")
    ref = JReplaySource(ours, use_native=False)
    try:
        assert src.backend == backend
        for i in range(FRAMES):
            a, b = src.get(i), ref.get(i)
            np.testing.assert_array_equal(a.rgb, b.rgb)
            np.testing.assert_array_equal(a.depth, b.depth)  # NaN where JAX has it
            np.testing.assert_array_equal(a.status, b.status)
            assert a.index == b.index == i
        assert src.get(2).status.tolist() == [0, 7]
    finally:
        src.close()
        ref.close()


def test_replay_cameras_equal_jax(files):
    ours, _ = files
    src, ref = ReplaySource(ours), JReplaySource(ours, use_native=False)
    try:
        got = [dataclasses.asdict(c) for c in src.cameras()]
        want = [dataclasses.asdict(c) for c in ref.cameras()]
        assert got == want and len(got) == CAMS
        assert src.num_cameras == CAMS and src.num_frames == FRAMES and src.frame_hw == (H, W)
    finally:
        src.close()
        ref.close()


@pytest.mark.parametrize("backend", ["native", "memmap"])
def test_replay_loop_wraps_and_range_raises(files, backend):
    ours, _ = files
    looped = ReplaySource(ours, use_native=backend == "native", loop=True)
    plain = ReplaySource(ours, use_native=backend == "native")
    try:
        assert looped.get(FRAMES + 1).index == 1
        np.testing.assert_array_equal(looped.get(FRAMES + 1).rgb, plain.get(1).rgb)
        for bad in (FRAMES, -1):
            with pytest.raises(IndexError):
                plain.get(bad)
    finally:
        looped.close()
        plain.close()


def _native_tree():
    """(name, sha256) of every file under native/ but the JAX binding's own
    library, which the JAX package's tests may build concurrently."""
    out = {}
    for p in sorted((ROOT / "native").iterdir()):
        if p.is_file() and p.name != "librt3d_replayer.so":
            out[p.name] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def test_replayer_library_builds_under_build_only(files):
    before = _native_tree()
    lib = native.build_library()
    src = ReplaySource(files[0])
    try:
        assert src.backend == "native"
    finally:
        src.close()
    assert lib == native.library_path() and lib.exists()
    assert lib.parent == ROOT / "build" / "rt3d_torch"
    assert _native_tree() == before and "replayer.cpp" in before


def test_closed_native_replayer_refuses_reads(files):
    src = ReplaySource(files[0])
    rep = src._native
    src.close()
    assert src.backend == "memmap" and rep is not None
    with pytest.raises(RuntimeError, match="closed"):
        rep.frame(0)


def test_replay_without_gxx_falls_back_to_memmap(files, monkeypatch):
    """A failed build leaves the memmap backend serving the same frames."""
    def no_gxx():
        raise OSError("no g++")

    monkeypatch.setattr(native, "build_library", no_gxx)
    native._load.cache_clear()
    try:
        src = ReplaySource(files[0])
        try:
            assert src.backend == "memmap"
            assert src.get(3).rgb.shape == (CAMS, H, W, 3)
        finally:
            src.close()
    finally:
        native._load.cache_clear()
