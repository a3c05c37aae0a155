"""Record the JAX package's step on the port's presets, as the golden the
port is held against (`rt3d_torch.golden`).

    python tools/make_torch_golden.py [--preset 2cam 2cam_cpu 1cam] [--frames 2]

For each preset of `rt3d_torch.pipeline.presets`, the port's preset config
must equal, as a dict, the JAX package's own reference config of that name
(`JAX_PRESETS`); the JAX config is then built from the port's config dict
on the source's cameras (as `tests/test_torch_step.py::run_both` does),
with the compute, preprocess and mask-resize dtypes all float32 and the
preset's committed weights. The JAX `Pipeline.step` runs op by op, not
under `jax.jit` (XLA's fused multiply-adds under `jit` move voxel keys
against the package's own eager result; see `tests/test_torch_step.py`),
on the CPU, over the preset's first synthetic HD720 frames with carried
state, and `rt3d_torch.golden.record` of its outputs goes to
`tests/golden_torch/<preset>.npz`. Takes 1-2 minutes and about 3 GiB of
memory per preset on an 8-core CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rt3d.config as jconfig  # noqa: E402
from rt3d.models.yolo import core as ycore  # noqa: E402
from rt3d.models.yolo.convert import load_params  # noqa: E402
from rt3d.pipeline.step import CameraCalib as JCalib  # noqa: E402
from rt3d.pipeline.step import build_pipeline as jbuild_pipeline  # noqa: E402
from rt3d_torch.golden import GOLDEN_DIR, golden_path, record  # noqa: E402
from rt3d_torch.pipeline.presets import (  # noqa: E402
    PRESETS, preset_config, preset_source, preset_weights,
)

JAX_PRESETS = {
    "2cam": jconfig.reference_2cam_config,
    "2cam_cpu": jconfig.reference_2cam_cpu_config,
    "1cam": jconfig.reference_1cam_config,
}


def golden_outputs(name: str, frames: int) -> tuple:
    """(config, JAX outputs per frame) of preset `name` in float32."""
    if PRESETS[name][0]().to_dict() != JAX_PRESETS[name]().to_dict():
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
    try:
        for i in range(frames):
            pkt = src.get(i)
            state, out = pipe.step(params, state, jnp.asarray(pkt.rgb),
                                   jnp.asarray(pkt.depth), calib)
            outs.append(out)
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)
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
        rec = record(outs, cfg.pipeline.subtraction_threshold)
        np.savez_compressed(golden_path(name), **rec)
        dets = [int(rec[f"f{i}_det_valid"].sum()) for i in range(args.frames)]
        objs = [int(rec[f"f{i}_obj_counts"].sum()) for i in range(args.frames)]
        ws = [len(rec[f"f{i}_ws_points"]) for i in range(args.frames)]
        print(f"{name}: {golden_path(name)} {os.path.getsize(golden_path(name))} bytes, "
              f"detections {dets}, object points {objs}, workspace kept {ws}, "
              f"{time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
