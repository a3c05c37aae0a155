"""The JAX golden of the port's presets and the comparison that holds the
port's float32 step against it (`rt3d_torch.golden`).

The files `tests/golden_torch/<preset>.npz` come from
`tools/make_torch_golden.py`: the JAX package's step in float32, op by op,
on the CPU, over the first two HD720 frames of each preset with its
committed weights. Here each file meets itself; a golden with one voxel,
one class or one track ID changed is refused; and the port itself, on the
CPU in float32, meets the 1cam golden on frame 0 (one HD720 step of
yolo11l, about 12 s). On the card `chip_smoke.py` holds every preset's
float32 step against its golden.
"""

import os

import numpy as np
import pytest
import torch

from rt3d_torch import golden
from rt3d_torch.pipeline.presets import PRESETS, synthetic_preset

FRAMES = 2


def _changed(g: dict, change: str) -> dict:
    """A copy of golden `g` with one thing changed in frame 1 (frame 0 for
    the workspace)."""
    g = {k: v.copy() for k, v in g.items()}
    det = np.argwhere(g["f1_det_valid"])[0]
    if change == "object_voxel":  # the first point of the first present slot
        g["f1_obj_points"][0] += np.float32(0.5)
    elif change == "workspace_voxel":  # the kept point farthest from the objects
        ws = g["f0_ws_points"]
        far = int(np.argmax(golden._min_d2(ws, g["f0_obj_points"])))
        ws[far, 2] += np.float32(0.01)
    elif change == "subtracted_point":  # kept 1 cm from an object point
        near = g["f0_obj_points"][:1] + np.float32([0, 0, 0.01])
        g["f0_ws_points"] = np.concatenate([g["f0_ws_points"], near])
    elif change == "class":
        g["f1_classes"][tuple(det)] += 1
    elif change == "track_id":
        g["f1_track_ids"][tuple(det)] += 1
    return g


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_golden_meets_itself(preset):
    """Every difference of a golden from itself is 0, and each frame holds
    detections with track IDs, fused object points and a workspace."""
    g = golden.load_golden(preset)
    m = golden.measure(g, g)
    golden.check_bands(m)
    assert m["frames"] == int(g["frames"]) == FRAMES
    assert all(v == 0 for k, v in m.items() if k not in ("frames", "ws_kept"))
    for i in range(FRAMES):
        valid = g[f"f{i}_det_valid"]
        assert valid.any() and (g[f"f{i}_track_ids"][valid] > 0).all()
        assert g[f"f{i}_obj_counts"].sum() > 100 and len(g[f"f{i}_ws_points"]) > 10000
        assert g[f"f{i}_obj_counts"].sum() == len(g[f"f{i}_obj_points"])


@pytest.mark.parametrize("change", ["object_voxel", "workspace_voxel", "subtracted_point",
                                    "class", "track_id"])
def test_golden_comparison_refuses_one_change(change):
    """2cam_cpu's fused slots hold 66-126 voxels, where the 1 % voxel band
    rounds down to none, so one moved object voxel is refused as surely as
    a moved workspace voxel, a workspace point within 6 cm of the objects
    (one that subtraction should have dropped), a class or a track ID."""
    g = golden.load_golden("2cam_cpu")
    m = golden.measure(_changed(g, change), g)
    key = {"object_voxel": "voxel_slots_over", "workspace_voxel": "ws_unexplained",
           "subtracted_point": "ws_unexplained", "class": "det_class",
           "track_id": "track_id"}[change]
    assert m[key] >= 1
    with pytest.raises(AssertionError, match=key):
        golden.check_bands(m)


def test_golden_refuses_workspace_explained_by_objects():
    """A workspace point that differing object points explain (the port's
    objects moved 1 m away, a point 1 cm from the golden's objects kept) is
    measured as such and refused: in float32 the workspace allows ties
    only."""
    g = golden.load_golden("2cam_cpu")
    got = {k: v.copy() for k, v in g.items()}
    near = g["f0_obj_points"][:1] + np.float32([0, 0, 0.01])
    got["f0_ws_points"] = np.concatenate([g["f0_ws_points"], near])
    got["f0_obj_points"] += np.float32([1, 0, 0])
    m = golden.measure(got, g)
    assert m["ws_only_port"] == 1 and m["ws_by_objects"] == 1 and m["ws_unexplained"] == 0
    with pytest.raises(AssertionError, match="ws_by_objects"):
        golden.check_bands(m)


def test_golden_voxel_band_is_one_percent():
    """In 2cam's 392-voxel slot a moved voxel counts twice (one voxel
    missing, one extra) and stays within floor(3.92) = 3; two moved
    voxels count 4 and are refused."""
    g = golden.load_golden("2cam")
    assert g["f0_obj_counts"][g["f0_obj_present"]][0] == 392
    one = {k: v.copy() for k, v in g.items()}
    one["f0_obj_points"][0] += np.float32(0.5)
    m = golden.measure(one, g)
    assert m["voxels_differing"] == 2 and m["voxel_slots_over"] == 0
    golden.check_bands(m)
    one["f0_obj_points"][1] += np.float32(0.5)
    m = golden.measure(one, g)
    assert m["voxels_differing"] == 4 and m["voxel_slots_over"] == 1
    with pytest.raises(AssertionError, match="voxel_slots_over"):
        golden.check_bands(m)


def test_port_on_cpu_meets_1cam_golden():
    """The port's 1cam step on the CPU in float32, frame 0: detections,
    track IDs and every fused voxel equal the JAX package's; the kept
    workspace differs only at ties with the 6 cm threshold."""
    pipe, src = synthetic_preset("1cam", 1, device="cpu", dtype="float32")
    pkt = src.get(0)
    _, out = pipe.step(pipe.init_state(), torch.from_numpy(pkt.rgb),
                       torch.from_numpy(pkt.depth), pipe.calib())
    m = golden.compare_to_golden([out], golden.load_golden("1cam"))
    assert m["frames"] == 1
    assert m["voxels_differing"] == 0 and m["ws_by_objects"] == 0
    assert m["box_max_px"] <= golden.BOX_ATOL and m["score_max"] <= golden.SCORE_ATOL


def test_lattice_coding_round_trips(tmp_path, monkeypatch):
    """`encode_lattice` stores 2cam's voxel-centre points as 5 mm lattice
    index differences, under a thirtieth of the floats' compressed size,
    and `load_golden` gives back every array: the workspace as the same
    multiset of float32 rows, the rest bit for bit."""
    g = golden.load_golden("2cam")
    enc = golden.encode_lattice(g, 0.005)
    assert sorted(k for k in enc if k.endswith("_lattice")) == [
        "f0_obj_lattice", "f0_ws_lattice", "f1_obj_lattice", "f1_ws_lattice"]
    np.savez_compressed(tmp_path / "2cam.npz", **enc)
    assert (tmp_path / "2cam.npz").stat().st_size * 30 < os.path.getsize(golden.golden_path("2cam"))
    monkeypatch.setattr(golden, "GOLDEN_DIR", str(tmp_path))
    back = golden.load_golden("2cam")
    assert set(back) == set(g) | {"voxel_size"}
    for k, v in g.items():
        if k.endswith("_ws_points"):
            assert len(back[k]) == len(v)
            assert golden._only(back[k], v).size == 0 and golden._only(v, back[k]).size == 0
        else:
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    off = {**g, "f0_ws_points": g["f0_ws_points"] + np.float32(1e-4)}
    assert "f0_ws_points" in golden.encode_lattice(off, 0.005)
