"""Record the JAX package's step on the port's presets, as the golden the
port is held against (`rt3d_torch.golden`).

    python tools/make_torch_golden.py [--preset NAME ...] [--frames 2]

For each preset of `rt3d_torch.pipeline.presets`, the port's preset config
must equal, as a dict, the JAX package's reference config of the same name
with the preset's overrides applied (`jax_config`); the JAX config is then
built from the port's config dict on the source's cameras (as
`tests/test_torch_step.py::run_both` does), with the compute, preprocess
and mask-resize dtypes all float32 and the preset's committed weights. The
JAX `Pipeline.step` runs op by op, not under `jax.jit` (XLA's fused
multiply-adds under `jit` move voxel keys against the package's own eager
result; see `tests/test_torch_step.py`), on the CPU, over the preset's
first synthetic HD720 frames with carried state, and
`rt3d_torch.golden.record` of its outputs, its voxel-centre points
lattice-coded (`encode_lattice`), goes to `tests/golden_torch/<preset>.npz`.

The JAX step's subtraction (`min_sqdist_to_set`, its CPU form) makes an
(N, 2048) matrix of all N workspace queries at once: 8 GiB at the 4-camera
stretch preset's 1 048 576 queries. Here it is called on blocks of 65 536
queries instead; each query's distance is computed as before. Takes 1-2
minutes and about 3 GiB of memory per two-camera preset on an 8-core CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rt3d.config as jconfig  # noqa: E402
import rt3d.geometry.subtract as jsubtract  # noqa: E402
from rt3d.models.yolo import core as ycore  # noqa: E402
from rt3d.models.yolo.convert import load_params  # noqa: E402
from rt3d.pipeline.step import CameraCalib as JCalib  # noqa: E402
from rt3d.pipeline.step import build_pipeline as jbuild_pipeline  # noqa: E402
from rt3d_torch.golden import GOLDEN_DIR, encode_lattice, golden_path, record  # noqa: E402
from rt3d_torch.pipeline.presets import (  # noqa: E402
    PRESETS, preset_config, preset_source, preset_weights,
)

QUERY_BLOCK = 65536
_min_sqdist_to_set = jsubtract.min_sqdist_to_set


def _blocked_min_sqdist(queries, query_valid, refs, ref_valid, tile=2048):
    return jnp.concatenate([
        _min_sqdist_to_set(queries[q0:q0 + QUERY_BLOCK], query_valid[q0:q0 + QUERY_BLOCK],
                           refs, ref_valid, tile)
        for q0 in range(0, queries.shape[0], QUERY_BLOCK)])


def jax_config(name: str) -> jconfig.Config:
    """The JAX package's reference config of preset `name`'s base, with the
    preset's overrides."""
    p = PRESETS[name]
    cfg = getattr(jconfig, p.base.__name__)()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **p.model),
        tracker=dataclasses.replace(cfg.tracker, **p.tracker),
        pipeline=dataclasses.replace(cfg.pipeline, **p.pipeline))


def golden_outputs(name: str, frames: int) -> tuple:
    """(config, JAX outputs per frame) of preset `name` in float32."""
    if PRESETS[name].config().to_dict() != jax_config(name).to_dict():
        raise SystemExit(f"{name}: the port's preset config differs from the JAX package's")
    src = preset_source(name, frames)
    cfg = preset_config(name, src, "float32")
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    pipe = jbuild_pipeline(jcfg)
    params = {k: jnp.asarray(v, jnp.float32)
              for k, v in load_params(preset_weights(name)).items()}
    state, calib = pipe.init_state(), JCalib.from_config(jcfg)
    outs = []
    ycore.set_compute_dtype(jnp.float32)
    jsubtract.min_sqdist_to_set = _blocked_min_sqdist
    try:
        for i in range(frames):
            pkt = src.get(i)
            state, out = pipe.step(params, state, jnp.asarray(pkt.rgb),
                                   jnp.asarray(pkt.depth), calib)
            outs.append(out)
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)
        jsubtract.min_sqdist_to_set = _min_sqdist_to_set
    return cfg, outs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", nargs="+", choices=sorted(PRESETS), default=sorted(PRESETS))
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args()
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in args.preset:
        t = time.perf_counter()
        cfg, outs = golden_outputs(name, args.frames)
        rec = record(outs, cfg.pipeline.subtraction_threshold, cfg.pipeline.workspace_accumulate)
        np.savez_compressed(golden_path(name), **encode_lattice(rec, cfg.pipeline.voxel_size))
        dets = [int(rec[f"f{i}_det_valid"].sum()) for i in range(args.frames)]
        objs = [int(rec[f"f{i}_obj_counts"].sum()) for i in range(args.frames)]
        ws = [len(rec[f"f{i}_ws_points"]) for i in range(args.frames)]
        print(f"{name}: {golden_path(name)} {os.path.getsize(golden_path(name))} bytes, "
              f"detections {dets}, object points {objs}, workspace kept {ws}, "
              f"{time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
