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

A tracker preset's golden also records, per frame, what its step's tracker
was given (`rt3d_torch.golden.Probe` on the port's side): the detections'
embeddings from `detect`, the GMC warps the step computes (after
`rescale_warp`, by the step's own functions) and the track IDs that
ByteTrack alone, with the preset's thresholds, gives on the same
detections. A quantized preset is quantized as the JAX apps do it: the
model calibrated live (in float32) on frames 0 to `CALIB_FRAMES` - 1 of the
source through the pipeline's preprocessing, then `quant.quantize_params`
on the float32 weights; its golden stores the activation scales used.

`--preset train_x` records one training step instead
(`rt3d_torch.golden.train_record`): `build_synth_dataset(**TRAIN_DATA)`
with the JAX package's synthetic source, both cameras of its scene 1,
letterboxed by the JAX `preprocess_frame` in float32; the x model with
the committed weights in float32; `seg_detection_loss` and its gradient
under `jax.jit`; then one update of `tools/train_synth.py`'s optimizer
chain at `TRAIN_OPT` (warm-up 0). It takes about 50 s and 4.3 GB of
memory on an 8-core CPU.

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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rt3d.config as jconfig  # noqa: E402
import rt3d.geometry.subtract as jsubtract  # noqa: E402
from rt3d.models.yolo import core as ycore  # noqa: E402
from rt3d.models.yolo import quant as jquant  # noqa: E402
from rt3d.models.yolo.convert import load_params  # noqa: E402
from rt3d.pipeline.step import CameraCalib as JCalib  # noqa: E402
from rt3d.pipeline.step import build_pipeline as jbuild_pipeline  # noqa: E402
from rt3d.tracking import botsort as jbotsort  # noqa: E402
from rt3d.tracking.bytetrack import bytetrack_init, bytetrack_step  # noqa: E402
from rt3d_torch.golden import (  # noqa: E402
    GOLDEN_DIR, TRAIN_DATA, TRAIN_GOLDEN, TRAIN_OPT, TRAIN_WEIGHTS, batch_hashes, encode_lattice,
    golden_path, record, train_batch, train_record,
)
from rt3d_torch.pipeline.presets import (  # noqa: E402
    CALIB_FRAMES, PRESETS, preset_config, preset_source, preset_weights,
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


def probe_track(pipe, frames: list) -> None:
    """Wrap `pipe.track` (the JAX step's) so that each call appends to
    `frames` the extras of `rt3d_torch.golden.record`: the embeddings it is
    given, the GMC warps it computes (the step's own code, step.py:260-287)
    and ByteTrack's IDs on the same detections, from a ByteTrack state of
    its own."""
    track, t = pipe.track, pipe.cfg.tracker
    fps = pipe.cfg.rig.cameras[0].fps
    bt = [jax.vmap(lambda _: bytetrack_init(t.max_tracks, emb_dim=t.emb_dim))(
        jnp.arange(pipe.cfg.rig.num_cameras))]

    def probed(state, det, det_emb=None, images=None):
        bt[0], ids = jax.vmap(lambda ts, d: bytetrack_step(ts, d, t, frame_rate=fps))(bt[0], det)
        frame = {"bytetrack_ids": ids}
        if det_emb is not None:
            frame["det_emb"] = det_emb
        if pipe._use_gmc and images is not None:
            gh, gw = pipe._gray_hw()
            gray = jax.vmap(lambda im: jax.image.resize(im.mean(axis=-1), (gh, gw), "linear"))(
                images.astype(jnp.float32))
            if t.gmc_method == "affine":
                warps = jax.vmap(jbotsort.estimate_affine_gmc)(state.prev_gray, gray)
            else:
                warps = jax.vmap(lambda a, b: jbotsort.translation_warp(
                    jbotsort.estimate_translation_gmc(a, b)))(state.prev_gray, gray)
            meta = pipe._meta()
            frame["gmc_warp"] = jax.vmap(lambda wp: jbotsort.rescale_warp(
                wp, meta.ratio / 4.0, (meta.pad_left / 4.0, meta.pad_top / 4.0)))(warps)
        frames.append(frame)
        return track(state, det, det_emb=det_emb, images=images)

    object.__setattr__(pipe, "track", probed)


def golden_outputs(name: str, frames: int) -> tuple:
    """(config, JAX outputs per frame, extras per frame or None, activation
    scales or None) of preset `name` in float32."""
    if PRESETS[name].config().to_dict() != jax_config(name).to_dict():
        raise SystemExit(f"{name}: the port's preset config differs from the JAX package's")
    src = preset_source(name, frames)
    cfg = preset_config(name, src, "float32")
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    pipe = jbuild_pipeline(jcfg)
    params = {k: jnp.asarray(v, jnp.float32)
              for k, v in load_params(preset_weights(name)).items()}
    state, calib = pipe.init_state(), JCalib.from_config(jcfg)
    outs, extras, scales = [], None, None
    if pipe._use_reid or pipe._use_gmc:
        extras = []
        probe_track(pipe, extras)
    ycore.set_compute_dtype(jnp.float32)
    jsubtract.min_sqdist_to_set = _blocked_min_sqdist
    try:
        if PRESETS[name].quantize:
            scales = jquant.collect_act_scales(pipe.model, params, jquant.synth_calib_batches(
                pipe, src, frames=tuple(range(CALIB_FRAMES))))
            params = jquant.quantize_params(pipe.model, params, (), act_scales=scales)
        for i in range(frames):
            pkt = src.get(i)
            state, out = pipe.step(params, state, jnp.asarray(pkt.rgb),
                                   jnp.asarray(pkt.depth), calib)
            outs.append(out)
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)
        jsubtract.min_sqdist_to_set = _min_sqdist_to_set
    return cfg, outs, extras, scales


def train_golden() -> dict:
    """The `train_x` record: one float32 training step of the JAX package
    (module docstring)."""
    import optax

    from rt3d.models.yolo.model import YoloSeg
    from rt3d.models.yolo.postprocess import letterbox_params, preprocess_frame
    from rt3d.train.data import build_synth_dataset
    from rt3d.train.loss import seg_detection_loss

    model = YoloSeg(variant="x", num_classes=80, input_hw=(384, 640))
    batch = train_batch(build_synth_dataset(model, **TRAIN_DATA))
    meta = letterbox_params(TRAIN_DATA["hw"], model.input_hw)
    params = {k: jnp.asarray(v, jnp.float32) for k, v in load_params(TRAIN_WEIGHTS).items()}
    lr, warmup, steps = TRAIN_OPT["lr"], TRAIN_OPT["warmup"], TRAIN_OPT["steps"]
    chain = optax.chain(optax.zero_nans(), optax.clip_by_global_norm(5.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup, decay_steps=steps,
                                           end_value=lr * 0.05), b2=0.95, weight_decay=1e-4))
    ycore.set_compute_dtype(jnp.float32)
    try:
        images = jax.vmap(lambda f: preprocess_frame(f, meta, jnp.float32))(
            jnp.asarray(batch["images"]))
        targets = {k: jnp.asarray(v) for k, v in batch.items() if k != "images"}
        (loss, parts), grads = jax.jit(jax.value_and_grad(
            lambda p: seg_detection_loss(model, p, images, targets), has_aux=True))(params)
        updates, _ = jax.jit(chain.update)(grads, chain.init(params), params)
    finally:
        ycore.set_compute_dtype(jnp.bfloat16)
    return train_record(float(loss), {k: float(v) for k, v in parts.items()},
                        {k: np.asarray(v) for k, v in grads.items()},
                        {k: np.asarray(v) for k, v in updates.items()},
                        {k: np.asarray(v) for k, v in params.items()}, batch_hashes(batch))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", nargs="+", choices=sorted(PRESETS) + [TRAIN_GOLDEN],
                    default=sorted(PRESETS) + [TRAIN_GOLDEN])
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args()
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name in args.preset:
        t = time.perf_counter()
        if name == TRAIN_GOLDEN:
            rec = train_golden()
            np.savez_compressed(golden_path(name), **rec)
            print(f"{name}: {golden_path(name)} {os.path.getsize(golden_path(name))} bytes, "
                  f"loss {float(rec['loss']):.6f}, grad norm "
                  f"{float(rec['grad_global_norm']):.6f}, {time.perf_counter() - t:.1f} s",
                  flush=True)
            continue
        cfg, outs, extras, scales = golden_outputs(name, args.frames)
        rec = record(outs, cfg.pipeline.subtraction_threshold, cfg.pipeline.workspace_accumulate,
                     extras)
        if scales is not None:
            paths = sorted(scales)
            rec["act_paths"] = np.array(paths)
            rec["act_scales"] = np.array([scales[p] for p in paths], np.float32)
        np.savez_compressed(golden_path(name), **encode_lattice(rec, cfg.pipeline.voxel_size))
        dets = [int(rec[f"f{i}_det_valid"].sum()) for i in range(args.frames)]
        objs = [int(rec[f"f{i}_obj_counts"].sum()) for i in range(args.frames)]
        ws = [len(rec[f"f{i}_ws_points"]) for i in range(args.frames)]
        print(f"{name}: {golden_path(name)} {os.path.getsize(golden_path(name))} bytes, "
              f"detections {dets}, object points {objs}, workspace kept {ws}, "
              f"{time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
