"""The JAX golden of the port's presets and the comparison that holds the
port's float32 step against it (`rt3d_torch.golden`).

The files `tests/golden_torch/<preset>.npz` come from
`tools/make_torch_golden.py`: the JAX package's step in float32, op by op,
on the CPU, over the first two HD720 frames of each preset with its
committed weights. Here each file meets itself; a golden with one voxel,
one class, one track ID or one of a tracker preset's records changed is
refused; the two tracker goldens tell BoT-SORT, DeepSORT and ByteTrack
apart; the 2cam_int8 golden's stored activation scales quantize the x
weights; and the port itself, on the CPU in float32, meets the 1cam golden
on frame 0 (one HD720 step of yolo11l, about 12 s). On the card
`chip_smoke.py` holds every preset's float32 step against its golden.
The `train_x` golden (one float32 training step of yolo11x) is checked
for its contents, and its batch against the port's data; the card holds
the port's step against it (`chip_smoke.py` phase 12).
"""

import os

import numpy as np
import pytest
import torch

from rt3d_torch import golden
from rt3d_torch.models import quant
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
    detections with track IDs (every one of frame 0's, which all start
    tracks; later a detection that starts a track has none until it is
    confirmed, ID -1, as in the tracker presets' scene), fused object
    points and a workspace."""
    g = golden.load_golden(preset)
    m = golden.measure(g, g)
    golden.check_bands(m)
    assert m["frames"] == int(g["frames"]) == FRAMES
    assert all(v == 0 for k, v in m.items() if k not in ("frames", "ws_kept"))
    for i in range(FRAMES):
        valid = g[f"f{i}_det_valid"]
        ids = g[f"f{i}_track_ids"][valid]
        assert valid.any() and (ids > 0).any() and ((ids > 0) | (ids == -1)).all()
        assert i > 0 or (ids > 0).all()
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


TRACKERS = ("2cam_botsort", "2cam_deepsort")


def test_tracker_goldens_tell_the_trackers_apart():
    """The BoT-SORT and DeepSORT goldens differ as files. Each records per
    frame the detections' embeddings and the IDs that ByteTrack alone gives
    on the same detections (the same in both), and its own track IDs
    differ from ByteTrack's, and from the other tracker's, on some frame;
    BoT-SORT's GMC warps are recorded and are not all the identity."""
    files = [open(golden.golden_path(p), "rb").read() for p in TRACKERS]
    assert files[0] != files[1]
    gb, gd = (golden.load_golden(p) for p in TRACKERS)
    n = int(gb["frames"])
    for g in (gb, gd):
        assert all(g[f"f{i}_det_emb"].shape == (2, 20, 64) for i in range(n))
        assert any(not np.array_equal(g[f"f{i}_track_ids"], g[f"f{i}_bytetrack_ids"])
                   for i in range(n))
    assert all(np.array_equal(gb[f"f{i}_bytetrack_ids"], gd[f"f{i}_bytetrack_ids"])
               for i in range(n))
    assert any(not np.array_equal(gb[f"f{i}_track_ids"], gd[f"f{i}_track_ids"])
               for i in range(n))
    warps = np.stack([gb[f"f{i}_gmc_warp"] for i in range(n)])
    assert warps.shape == (n, 2, 2, 3)
    assert not np.allclose(warps, np.eye(2, 3, dtype=np.float32), rtol=0, atol=1e-6)
    assert not any(k.endswith("_gmc_warp") for k in gd)


@pytest.mark.parametrize("change", ["det_emb", "gmc_warp", "gmc_shift", "bytetrack_ids",
                                    "missing"])
def test_golden_comparison_refuses_tracker_extras(change):
    """A BoT-SORT record whose embedding moved 1e-3, whose warp's linear
    part moved 2e-3 or translation 0.1 px, whose ByteTrack ID changed, or
    which lacks the records, is refused."""
    g = golden.load_golden("2cam_botsort")
    got = {k: v.copy() for k, v in g.items()}
    det = tuple(np.argwhere(g["f1_det_valid"])[0])
    if change == "det_emb":
        got["f1_det_emb"][det] += np.float32(1e-3)
    elif change == "gmc_warp":
        got["f1_gmc_warp"][0, 0, 1] += np.float32(2e-3)
    elif change == "gmc_shift":
        got["f1_gmc_warp"][1, 1, 2] += np.float32(0.1)
    elif change == "bytetrack_ids":
        got["f1_bytetrack_ids"][det] += 1
    else:
        del got["f1_det_emb"], got["f1_gmc_warp"]
    m = golden.measure(got, g)
    key = {"det_emb": "emb_max", "gmc_warp": "warp_max", "gmc_shift": "warp_shift_max",
           "bytetrack_ids": "bytetrack_id", "missing": "extras_missing"}[change]
    assert m[key] > 0
    with pytest.raises(AssertionError, match=key):
        golden.check_bands(m, "2cam_botsort")


def test_int8_golden_decodes_with_its_scales():
    """2cam_int8's golden stores the activation scales of the JAX package's
    float32 calibration, one per conv of the x model; the x weights
    quantized against them (numpy only: no HD720 x step on this CPU) hold
    them in their 98 int8 convs, as phase 9 of `chip_smoke.py` loads them.
    The golden's detections carry track IDs and its frames object voxels."""
    from rt3d_torch.models.yolo import YoloSeg, load_flat
    from rt3d_torch.pipeline.presets import preset_weights

    g = golden.load_golden("2cam_int8")
    scales = golden.golden_act_scales(g)
    assert len(scales) == 185 and min(scales.values()) > 0
    model = YoloSeg(variant="x")
    q = quant.quantize_params(model, load_flat(preset_weights("2cam_int8"), model), (),
                              act_scales=scales)
    got = {k[:-len("/act_scale")]: float(v) for k, v in q.items() if k.endswith("/act_scale")}
    assert got == {p: v for p, v in scales.items() if not quant.default_exclude(p)}
    assert len(got) == 98
    assert PRESETS["2cam_int8"].quantize and int(g["frames"]) == FRAMES


def _train_golden() -> dict:
    with np.load(golden.golden_path(golden.TRAIN_GOLDEN)) as z:
        return {k: z[k] for k in z.files}


def test_train_golden_file():
    """The `train_x` golden (one float32 training step of the JAX package,
    `tools/make_torch_golden.py --preset train_x`) exists and is small; its
    loss and four parts are finite and positive; it has one gradient norm
    and one update norm per parameter leaf of the x model, named as
    `flat_from_model` names them, with the parameters' norms, all finite,
    the gradients' positive but
    on the mask branches that no selected anchor reaches;
    the head's last biases' whole gradients; and it meets itself while a
    1 % change of one leaf's gradient norm is refused."""
    from rt3d_torch.models.yolo import YoloSeg, flat_from_model

    assert os.path.getsize(golden.golden_path(golden.TRAIN_GOLDEN)) < 200_000
    g = _train_golden()
    parts = [g[f"part_{k}"] for k in ("cls", "box", "iou", "proto")]
    assert all(np.isfinite(v) and v > 0 for v in [g["loss"]] + parts)
    names = sorted(flat_from_model(YoloSeg(variant="x", input_hw=(384, 640))))
    assert list(g["names"]) == names and len(names) == 372
    assert g["grad_norms"].shape == g["update_norms"].shape == (len(names),)
    assert (g["param_norms"] > 0).all() and g["param_norms"].shape == (len(names),)
    assert np.isfinite(g["grad_norms"]).all() and np.isfinite(g["update_norms"]).all()
    # the mask coefficients of levels 2 and 3 get none: every selected
    # positive anchor (the top 32 by index among equal weights) is on level 1
    zero = [str(n) for n, v in zip(names, g["grad_norms"]) if v == 0]
    assert zero and all(n.startswith(("23/cv4/1/", "23/cv4/2/")) for n in zero)
    assert (g["update_norms"] > 0).all() and np.isfinite(g["grad_global_norm"])
    for k in golden.TRAIN_GRAD_LEAVES:
        assert g[f"grad/{k}"].shape in ((64,), (80,), (32,))
        assert (np.abs(g[f"grad/{k}"]).max() > 0) == (k not in zero)
    m = golden.measure_train(g, g)
    assert not any(m.values())
    golden.check_train_bands(m)
    moved = dict(g, grad_norms=g["grad_norms"].copy())
    moved["grad_norms"][len(names) // 2] *= 1.01
    with pytest.raises(AssertionError, match="grad_norm_rel"):
        golden.check_train_bands(golden.measure_train(moved, g))


def test_train_golden_batch_is_the_ports_data():
    """The port's `build_synth_dataset(**TRAIN_DATA)` (two HD720 frames
    rendered here) gives the golden's batch: every hash of its images and
    targets equal."""
    from types import SimpleNamespace

    from rt3d_torch.train.data import build_synth_dataset

    ds = build_synth_dataset(SimpleNamespace(input_hw=(384, 640), num_classes=80),
                             **golden.TRAIN_DATA)
    batch = golden.train_batch(ds)
    g = _train_golden()
    assert golden.batch_hashes(batch) == {k[len("hash_"):]: str(v) for k, v in g.items()
                                          if k.startswith("hash_")}
    assert sorted(batch) == sorted(("images",) + golden.TRAIN_TARGETS)
    assert batch["images"].shape == (2, 720, 1280, 3) and batch["box_w"].sum() > 32
