"""A configuration names its architecture (`arch/<name>.py`), and each
bounded kernel wrapper is a file (`bounds/<wrapper>.py`).

The YOLO11-seg cells keep the numbers they had when the harness named
YOLO11-seg itself: the FLOPs an image of the x and n models, the bound of
each wrapper call, and every compared number of a run of the small CPU
cell. A toy architecture, built only from new files in a test folder,
reaches the record with its FLOPs, its own compared number, its fault, its
stated config and its kernel bound, with no edit of a benchmark file; a
folder's file that would stand in for one of the benchmark's own is
refused."""

import importlib
import json
import os

import pytest
import torch

from bench_port import faults, roofline, spec, tracer
from bench_port.flops import yolo11_seg_flops
from bench_port.run import run_cell

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CELL = "small_2cam.objects4"

# the counts of the layer table before the architecture became a file
X_FLOPS, N_FLOPS = 177817374720, 5843258880
# every number of a run of the small cell at seed 2**31 + 7 (float32 on the
# CPU, program and reference alike) before the architecture became a file
SMALL_NUMBERS = {
    "det_unpaired": 0, "box_px_med": 0.0, "score_med": 0.0, "score_max": 0.0,
    "coeff_rel_med": 0.0, "coeff_off_share": 0.0, "obj_voxels": 0.0,
    "track_ids_diff": 0, "tracker_state_diff": 0, "fused_diff": 0, "workspace_diff": 0,
    "accum_diff": 0}


@pytest.mark.parametrize("config, variant, flops", [
    ("yolo11x_2cam_5mm", "x", X_FLOPS), ("yolo11n_4cam_1mm_accum", "n", N_FLOPS)])
def test_flops_per_image_is_pinned(config, variant, flops):
    assert yolo11_seg_flops(variant, (384, 640), 80) == flops
    conf = spec.load_json(os.path.join(spec.HERE, "configs", f"{config}.json"))
    assert "architecture" not in conf
    arch = spec.architecture(spec.DEFAULT_ARCHITECTURE)
    assert arch.flops_per_image(conf) == flops


def test_compared_numbers_are_pinned():
    result, numbers = run_cell(CELL, 2**31 + 7, 8.0, False, device="cpu", here=DATA,
                               bench={"end_to_end": [], "per_layer": []})
    assert numbers == SMALL_NUMBERS
    assert result["correct"] is True


def _inputs():
    gen = torch.Generator().manual_seed(3)
    kg = torch.randint(0, 40, (48, 64), generator=gen, dtype=torch.int32)
    kg[torch.rand((48, 64), generator=gen) < 0.3] = roofline.INT_SENTINEL
    wg = torch.randint(0, 4, (48, 64), generator=gen, dtype=torch.int32)
    pts = torch.rand((4, 64, 3), generator=gen)
    valid = torch.rand((4, 64), generator=gen) < 0.7
    q, r = torch.rand((300, 3), generator=gen), torch.rand((200, 3), generator=gen)
    rv = torch.rand(200, generator=gen) < 0.8
    return dict(kg=kg, wg=wg, pts=pts, valid=valid, q=q, r=r, rv=rv)


@pytest.mark.parametrize("wrapper", ["window_dedupe", "window_prev_or", "sor_knn_mean_slots",
                                     "sor_knn_mean", "min_sqdist"])
def test_each_wrapper_keeps_its_bound(wrapper):
    """The five files wrap what the tracer wrapped, match the kernel names
    it matched, and bound a call as `roofline.call_bound` did."""
    x = _inputs()
    calls = {
        "window_dedupe": (((x["kg"],), dict(dy_max=5, dx_max=7)),
                          roofline.k1_bound(x["kg"], 5, 7)),
        "window_prev_or": (((x["kg"], x["wg"]), {}), roofline.k2_bound(x["kg"], x["wg"], 4, 6)),
        "sor_knn_mean_slots": (((x["pts"], x["valid"], 8), {}),
                               roofline.k3_bound(x["pts"], x["valid"])),
        "sor_knn_mean": (((x["pts"][0], x["valid"][0], 8), {}),
                         roofline.k5_bound(x["pts"][0], x["valid"][0])),
        "min_sqdist": (((x["q"], x["r"], x["rv"]), dict(threshold=0.05, query_valid=None)),
                       roofline.k4_bound(x["q"], None, x["r"], x["rv"], 0.05)),
    }
    kernels = {"window_dedupe": ("window_kernel", "window_wide_kernel"),
               "window_prev_or": ("window_kernel", "window_wide_kernel"),
               "sor_knn_mean_slots": ("sor_knn_kernel", "sor_knn_large_kernel"),
               "sor_knn_mean": ("sor_knn_kernel", "sor_knn_large_kernel"),
               "min_sqdist": ("min_d2_kernel", "ref_boxes_kernel")}
    modules = {"window_dedupe": "rt3d_torch.geometry.ops",
               "window_prev_or": "rt3d_torch.geometry.ops",
               "sor_knn_mean_slots": "rt3d_torch.geometry.sor",
               "sor_knn_mean": "rt3d_torch.geometry.sor",
               "min_sqdist": "rt3d_torch.geometry.subtract"}
    b = roofline.kernel_bounds()[wrapper]
    assert (b.MODULE, b.FUNCTION) == (modules[wrapper], wrapper)
    assert callable(getattr(importlib.import_module(b.MODULE), b.FUNCTION))
    assert roofline.kernel_names()[wrapper] == kernels[wrapper]
    (args, kwargs), want = calls[wrapper]
    assert roofline.call_bound(wrapper, args, kwargs) == want


TOY_ARCH = '''
import dataclasses

import torch

from bench_port import spec

YOLO = spec.architecture("yolo11_seg")
FLOPS = 123456789
check_program = YOLO.check_program
reference_pipeline = YOLO.reference_pipeline
control = YOLO.control


def flops_per_image(conf):
    return FLOPS


def stated_config(conf, cameras, dtype=None):
    cfg = YOLO.stated_config(conf, cameras, dtype)
    if "toy_iou_thresh" in conf:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, iou_thresh=conf["toy_iou_thresh"]))
    return cfg


class ExtraNumbers:
    """How far (pixels) the program's valid boxes reach outside the image."""

    def __init__(self):
        self.outside = 0.0
        self.frames = 0

    def add(self, ref, ctx, masks, outputs):
        det = outputs.detections
        for c, cam in enumerate(ref.cfg.rig.cameras):
            b = det.boxes[c][det.valid[c]].float()
            w, h = cam.intrinsics.width, cam.intrinsics.height
            over = torch.stack([-b[:, 0], -b[:, 1], b[:, 2] - w, b[:, 3] - h], -1)
            self.outside = max(self.outside, float(over.clamp_min(0).max()) if len(b) else 0.0)
        self.frames += 1

    def numbers(self):
        return {"toy_box_outside_px": self.outside, "toy_frames": self.frames}


def boxes_moved(pipe):
    """Every published box moves 1000 pixels right, where it is produced."""
    step = pipe.step

    def f(state, rgb, depth, calib, stage=None):
        state, out = step(state, rgb, depth, calib, stage=stage)
        det = dataclasses.replace(out.detections, boxes=out.detections.boxes + 1000.0)
        return state, dataclasses.replace(out, detections=det)
    pipe.step = f
    return lambda: None


FAULTS = {"toy_boxes_moved": boxes_moved}
'''

TOY_BOUND = '''
MODULE = "rt3d_torch.geometry.ops"
FUNCTION = "window_prev_or"
KERNELS = ("toy_k2_kernel",)


def bound(args, kwargs):
    return {"bound_ms": 0.25, "bound_by": "operations"}
'''

TOY_METRIC = "def read(record):\n    return float(record['flops_per_image'])\n"


@pytest.fixture
def toy(tmp_path):
    """A folder of new files only: two toy configurations (one stating a
    config the program does not run), their cells, `arch/toy.py`,
    `bounds/toy_k2.py` and a metric reader `metrics/toy_flops.py`."""
    for sub in ("configs", "workloads", "arch", "bounds", "metrics"):
        (tmp_path / sub).mkdir()
    conf = json.loads(open(os.path.join(DATA, "configs", "small_2cam.json")).read())
    cell = json.loads(open(os.path.join(DATA, "workloads", f"{CELL}.json")).read())
    cell["check"]["limits"]["toy_box_outside_px"] = 1.0
    for name, extra in (("toy_small", {}), ("toy_departs", {"toy_iou_thresh": 0.6})):
        (tmp_path / "configs" / f"{name}.json").write_text(
            json.dumps(dict(conf, architecture="toy", **extra)))
        (tmp_path / "workloads" / f"{name}.objects4.json").write_text(
            json.dumps(dict(cell, config=name)))
    (tmp_path / "arch" / "toy.py").write_text(TOY_ARCH)
    (tmp_path / "bounds" / "toy_k2.py").write_text(TOY_BOUND)
    (tmp_path / "metrics" / "toy_flops.py").write_text(TOY_METRIC)
    return str(tmp_path)


def test_a_toy_architecture_needs_only_new_files(toy, monkeypatch):
    from rt3d_torch import kernels
    from rt3d_torch.geometry import ops

    before = {p: open(p, "rb").read() for p in _benchmark_files()}
    # K2 on the CPU takes its plain version and launches nothing: count a
    # launch a call, as the card would, so that the tracer records it
    orig = ops.window_prev_or

    def launching(*args, **kwargs):
        kernels.LAUNCHES["window_prev_or"] += 1
        return orig(*args, **kwargs)
    monkeypatch.setattr(ops, "window_prev_or", launching)
    monkeypatch.setitem(kernels.LAUNCHES, "window_prev_or", 0)
    # the traced slice's recorded calls and their bounds, read as the run
    # takes the tracer down
    seen = {}
    uninstall = tracer.Tracer.uninstall

    def spy(self):
        seen.update(calls=[n for n, _, _ in self.calls], bounds=list(self.bounds))
        uninstall(self)
    monkeypatch.setattr(tracer.Tracer, "uninstall", spy)

    bench = {"end_to_end": [], "per_layer": [{"name": "toy_flops", "unit": "x"}]}
    result, numbers = run_cell("toy_small.objects4", 2**31 + 11, 8.0, True, device="cpu",
                               here=toy, bench=bench)
    assert result["metrics"]["toy_flops"]["value"] == 123456789.0
    toy_bounds = [b for n, b in zip(seen["calls"], seen["bounds"]) if n == "toy_k2"]
    assert toy_bounds and toy_bounds == [0.25] * len(toy_bounds)
    assert seen["calls"].count("window_prev_or") == len(toy_bounds)
    assert result["checks"]["toy_box_outside_px"] == {"value": 0.0, "limit": 1.0}
    assert numbers["toy_frames"] == 1 + min(result["attempted"], 2)  # frame 0 and the kept
    assert result["correct"] is True, result["checks"]

    planted = faults.for_cell(spec.workload("toy_small.objects4", toy))
    fault = planted["toy_boxes_moved"]
    assert "toy_boxes_moved" not in faults.FAULTS and "k2_self_in_window" in planted
    result, numbers = run_cell("toy_small.objects4", 2**31 + 11, 8.0, False, device="cpu",
                               here=toy, bench=bench, fault=fault)
    assert result["correct"] is False
    assert numbers["toy_box_outside_px"] > 900.0

    with pytest.raises(ValueError, match="model.iou_thresh"):
        run_cell("toy_departs.objects4", 2**31 + 11, 8.0, False, device="cpu", here=toy,
                 bench=bench)
    assert before == {p: open(p, "rb").read() for p in _benchmark_files()}


@pytest.mark.parametrize("kind, name", [("metrics", "fps_like"), ("bounds", "window_prev_or"),
                                        ("arch", "yolo11_seg")])
def test_a_folder_adds_files_and_stands_in_for_none(tmp_path, kind, name):
    """A file under a test folder is loaded under a new name, and refused
    under a name of one of the benchmark's own files."""
    (tmp_path / kind).mkdir()
    (tmp_path / kind / f"{name}.py").write_text("WHO = 'folder'\n")
    if os.path.exists(os.path.join(spec.HERE, kind, f"{name}.py")):
        with pytest.raises(ValueError, match="the benchmark has its own"):
            spec.load(kind, name, str(tmp_path))
    else:
        assert spec.load(kind, name, str(tmp_path)).WHO == "folder"
    assert name in spec.names(kind, str(tmp_path))


def _benchmark_files():
    out = [os.path.join(spec.ROOT, "BENCHMARK.json")]
    for dirpath, dirs, files in os.walk(spec.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in files)
    return sorted(out)
