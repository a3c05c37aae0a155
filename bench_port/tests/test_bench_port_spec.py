"""Cells, configurations and per-layer metrics are found by name, and a run's
last line has the contract's schema."""

import json
import os
import shutil

import pytest

from bench_port import spec

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")


def test_every_cell_of_the_benchmark_has_its_files():
    bench = spec.benchmark()
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = spec.workload(w["name"])
        assert cell["config"] == w["config"] in configs
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_a_new_workload_file_is_found_by_name(tmp_path):
    for sub in ("configs", "workloads"):
        shutil.copytree(os.path.join(DATA, sub), tmp_path / sub)
    cell = json.loads((tmp_path / "workloads" / "small_2cam.objects4.json").read_text())
    cell["traffic"]["objects"] = 7
    (tmp_path / "workloads" / "small_2cam.objects7.json").write_text(json.dumps(cell))
    found = spec.workload("small_2cam.objects7", here=str(tmp_path))
    assert found["name"] == "small_2cam.objects7"
    assert found["traffic"]["objects"] == 7
    assert found["config_spec"]["variant"] == "n"
    with pytest.raises(FileNotFoundError):
        spec.workload("small_2cam.objects9", here=str(tmp_path))


def test_a_new_metric_file_is_found_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "frames_seen.py").write_text(
        "def read(record):\n    return float(len(record['frames']))\n")
    read = spec.metric_reader("frames_seen", here=str(tmp_path))
    assert read({"frames": [3, 4, 5]}) == 3.0


def test_cell_metrics_follow_the_workloads_key():
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x.y"]},
                           {"name": "c", "workloads": ["z.w"]}]}
    assert [m["name"] for m in spec.cell_metrics(bench, "x.y", "per_layer")] == ["a", "b"]


def test_the_last_line_schema():
    """A CPU run of the small test cell (the look for a card skipped): the
    keys the contract names, `checks` last, each with a value and a limit."""
    from bench_port.run import run_cell

    bench = {"end_to_end": [{"name": "fps", "unit": "frames/s"},
                            {"name": "latency_p95_ms", "unit": "ms"},
                            {"name": "setup_s", "unit": "s"}], "per_layer": []}
    result, numbers = run_cell("small_2cam.objects4", 2**31 + 5, 8.0, False, device="cpu",
                               here=DATA, bench=bench)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"fps", "latency_p95_ms", "setup_s"}
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, v in line["checks"].items():
        assert set(v) == {"value", "limit"} and name in numbers


def test_a_program_config_that_departs_from_the_stated_one_is_refused(monkeypatch):
    """The program's configuration is held to the stated one field by field:
    a changed default of the program's config functions refuses the run."""
    import dataclasses

    from bench_port.run import build_program
    from bench_port.synthetic import EasyScene
    from rt3d_torch import config as pconfig

    cell = spec.workload("small_2cam.objects4", here=DATA)
    scene = EasyScene(2, 1, 0, (180, 320))
    base = pconfig.reference_2cam_config

    def changed():
        cfg = base()
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, iou_thresh=0.6))
    monkeypatch.setattr(pconfig, "reference_2cam_config", changed)
    with pytest.raises(ValueError, match="model.iou_thresh"):
        build_program(cell, scene, "cpu")


def test_config_differences():
    import dataclasses

    @dataclasses.dataclass
    class Inner:
        a: float = 1.0
        b: tuple = (1, 2)

    @dataclasses.dataclass
    class Outer:
        inner: Inner = dataclasses.field(default_factory=Inner)
        c: str = "x"

    @dataclasses.dataclass
    class Wider(Outer):
        d: int = 0

    assert spec.config_differences(Outer(), Outer()) == ([], [])
    assert spec.config_differences(Outer(Inner(b=(1, 3))), Outer()) == (["inner.b[1]: 3 against 2"], [])
    assert spec.config_differences(Wider(), Outer()) == ([], ["d"])
    assert spec.config_differences(Outer(), Wider())[0] == ["d: missing"]


def test_rendered_frames_are_read_back(tmp_path, monkeypatch):
    """The frames are rendered once and later runs read them back equal."""
    import numpy as np

    from bench_port import run
    from bench_port.synthetic import EasyScene

    monkeypatch.setattr(run, "FRAME_CACHE", str(tmp_path))
    traffic = spec.workload("small_2cam.objects4", here=DATA)["traffic"]
    scene = EasyScene(traffic["cameras"], traffic["objects"], traffic["scene_seed"],
                      tuple(traffic["hw"]))
    first = run.rendered_frames(scene, traffic)
    assert len(list(tmp_path.iterdir())) == 2
    monkeypatch.setattr(scene, "render_all", None)  # a second render would fail
    again = run.rendered_frames(scene, traffic)
    assert len(first) == len(again) == traffic["rendered_frames"]
    for (r0, d0), (r1, d1) in zip(first, again):
        assert np.array_equal(r0, r1) and np.array_equal(d0, d1, equal_nan=True)
    r, d = EasyScene(traffic["cameras"], traffic["objects"], traffic["scene_seed"],
                     tuple(traffic["hw"])).render(3)
    assert np.array_equal(again[3][0], r) and np.array_equal(again[3][1], d, equal_nan=True)
