"""What a cell is, found by name: `BENCHMARK.json` at the root of the
checkout, `configs/<config>.json` and `workloads/<cell>.json` beside this
file, a reader `metrics/<metric>.py` for each per-layer metric, a module
`arch/<architecture>.py` for each architecture that a configuration file
names (`"architecture"`, `yolo11_seg` where it names none), and a file
`bounds/<wrapper>.py` for each kernel wrapper whose launches get a bound.
A new configuration, cell, architecture, kernel bound or per-layer metric
is a new file (and, for a cell or a metric, a new entry in
`BENCHMARK.json`); nothing here names one.

Each loader takes `here`, the folder that holds `configs/` and
`workloads/`. Another folder than this one may add `metrics/`, `arch/` and
`bounds/` files under new names only: a name that the benchmark's own files
beside this module already have is refused, so a folder never stands in for
one of them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEFAULT_ARCHITECTURE = "yolo11_seg"


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, here: str = HERE) -> Dict:
    """The cell `name`: its workload file, with its configuration's file
    under ``"config_spec"`` and the module of the architecture that the
    configuration names under ``"arch"``."""
    cell = load_json(os.path.join(here, "workloads", f"{name}.json"))
    cell["name"] = name
    cell["config_spec"] = load_json(os.path.join(here, "configs", f"{cell['config']}.json"))
    cell["arch"] = architecture(cell["config_spec"].get("architecture", DEFAULT_ARCHITECTURE),
                                here)
    return cell


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics that cell `cell`
    reports: those without a `workloads` list, and those that list it."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def _path(kind: str, name: str, here: str) -> str:
    own = os.path.join(HERE, kind, f"{name}.py")
    added = os.path.join(here, kind, f"{name}.py")
    if os.path.abspath(here) == HERE or not os.path.exists(added):
        return own
    if os.path.exists(own):
        raise ValueError(f"{added}: the benchmark has its own {kind}/{name}.py")
    return added


def load(kind: str, name: str, here: str = HERE):
    """The module `<kind>/<name>.py` (beside this file, or new under
    `here`), loaded by path."""
    spec = importlib.util.spec_from_file_location(f"bench_port_{kind}_{name}",
                                                  _path(kind, name, here))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, here: str = HERE) -> List[str]:
    """The names of the `<kind>/*.py` files under `here` and beside this
    file."""
    found = set()
    for folder in {here, HERE}:
        d = os.path.join(folder, kind)
        if os.path.isdir(d):
            found.update(f[:-3] for f in os.listdir(d) if f.endswith(".py") and f[0] != "_")
    return sorted(found)


def metric_reader(name: str, here: str = HERE):
    """The `read(record)` function of `metrics/<name>.py`."""
    return load("metrics", name, here).read


def architecture(name: str, here: str = HERE):
    """The module `arch/<name>.py`: `flops_per_image(conf)`,
    `stated_config(conf, cameras, dtype=None)`, `check_program(cfg, conf)`,
    `reference_pipeline(conf, cameras, device, weights)`,
    `control(pipe, weights, conf, frames)` and, optionally,
    `FAULTS` and `ExtraNumbers` (see `bench_port.check`)."""
    return load("arch", name, here)


def make_config(cfgmod, spec: Dict, cameras: List[Dict], dtype: str = None):
    """A pipeline `Config` of module `cfgmod` (the program's or the
    reference's copy of it) for configuration `spec`: its reference config
    function, its overrides of the model, tracker and pipeline fields, and
    the scene's cameras, each keeping the base camera's frame rate and depth
    floor. ``dtype`` replaces the compute, preprocess and mask-resize
    dtypes."""
    cfg = getattr(cfgmod, spec["base"])()
    model = dict(spec.get("model", {}))
    if dtype is not None:
        model.update(compute_dtype=dtype, preprocess_dtype=dtype, mask_resize_dtype=dtype)
    if "input_hw" in model:
        model["input_hw"] = tuple(model["input_hw"])
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        tracker=dataclasses.replace(cfg.tracker, **spec.get("tracker", {})),
        pipeline=dataclasses.replace(cfg.pipeline, **spec.get("pipeline", {})))
    base = cfg.rig.cameras[0]
    cams = [cfgmod.CameraConfig(
        name=c["name"], serial=c["serial"],
        intrinsics=cfgmod.Intrinsics(**c["intrinsics"]),
        extrinsics=cfgmod.Extrinsics(rotation=tuple(map(tuple, c["rotation"])),
                                     translation=tuple(c["translation"])),
        fps=base.fps, depth_min_m=base.depth_min_m) for c in cameras]
    return cfgmod.with_cameras(cfg, cams)


def config_differences(program, stated) -> Tuple[List[str], List[str]]:
    """Compare two pipeline `Config` trees field by field (the program's
    and the reference's copy of the classes). Returns the fields whose
    values differ or that the program lacks, and the program's fields that
    the stated configuration lacks, each as a dotted path."""
    differ: List[str] = []
    extra: List[str] = []

    def walk(a, b, path):
        if dataclasses.is_dataclass(b):
            if not dataclasses.is_dataclass(a):
                differ.append(f"{path}: {a!r} is no {type(b).__name__}")
                return
            names_a = {f.name for f in dataclasses.fields(a)}
            for f in dataclasses.fields(b):
                sub = f"{path}.{f.name}" if path else f.name
                if f.name not in names_a:
                    differ.append(f"{sub}: missing")
                else:
                    walk(getattr(a, f.name), getattr(b, f.name), sub)
            names_b = {f.name for f in dataclasses.fields(b)}
            extra.extend(f"{path}.{n}" if path else n for n in sorted(names_a - names_b))
        elif isinstance(b, (tuple, list)):
            if not isinstance(a, (tuple, list)) or len(a) != len(b):
                differ.append(f"{path}: {a!r} against {b!r}")
                return
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        elif a != b:
            differ.append(f"{path}: {a!r} against {b!r}")

    walk(program, stated, "")
    return differ, extra
