"""Fine-tune YOLO11-seg on the synthetic analytic scenes, then score the
pipeline's own detections against the scenes' truth (port of
`tools/train_synth.py`).

    python -m rt3d_torch.apps.train_synth --variant x --steps 800 \\
        --resume weights/yolo11x_synth_seg.npz --out /tmp/x.npz

The flags are the JAX tool's, plus ``--device`` (default ``cuda``; a CUDA
device without a card is refused, never replaced by the CPU). The whole
letterboxed dataset is staged on the device once, through the inference
path's `preprocess_frame`. Each step draws a batch with the tool's numpy
sampling (the same seed picks the same samples), flips and jitters it
(`rt3d_torch.train.augment`) from a generator seeded by (seed + 7, step),
and takes one step of `rt3d_torch.train.step` with the tool's optimizer
(`synth_optimizer`). The parameters stay float32; the convolutions run in
bf16 unless ``--f32``. A non-finite loss, read every 50 steps and at the
last, aborts with exit code 2. The weights are saved as a float16 ``.npz``
in the JAX package's layout, which its ``load_params`` reads, beside a
``.json`` manifest with the tool's keys, after the post-training eval
(`rt3d_torch.train.eval`).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variant", default="n")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--scenes", type=int, default=24)
    p.add_argument("--frames-per-scene", type=int, default=3)
    p.add_argument("--hw", type=int, nargs=2, default=(720, 1280))
    p.add_argument("--input-hw", type=int, nargs=2, default=(384, 640))
    p.add_argument("--out", default="weights/yolo11n_synth_seg.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-frames", type=int, default=10)
    p.add_argument("--domain", default="mix", choices=("easy", "hard", "mix"),
                   help="training scene family: mix = 3/4 domain-randomized hard scenes "
                        "(occlusion/texture/lighting/distractors), 1/4 easy")
    p.add_argument("--resume", default=None, help="existing .npz to continue from")
    p.add_argument("--warmup", type=int, default=None,
                   help="LR warmup steps (default steps/5 capped at 100)")
    p.add_argument("--f32", action="store_true",
                   help="f32 compute (the BN-folded net trains in bf16 by default; deep "
                        "variants can need f32)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the tests pass cpu)")
    return p.parse_args(argv)


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The augmentation generator of `step`, seeded by (seed, step): the
    counterpart of ``jax.random.fold_in(PRNGKey(seed), step)``."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def stage_dataset(ds: dict, meta, device: torch.device) -> dict:
    """The dataset on `device`: the images letterboxed by the inference
    path's `preprocess_frame` (f32), one frame at a time, and the targets."""
    from rt3d_torch.models.postprocess import preprocess_frame

    dev = {"images": torch.stack([
        preprocess_frame(torch.from_numpy(f).to(device), meta) for f in ds["images"]])}
    for k in ("box", "box_w", "inst_id", "inst_cls", "inst_mask", "inst_box"):
        dev[k] = torch.from_numpy(ds[k]).to(device)
    return dev


def train(args: argparse.Namespace) -> dict:
    """Render, stage, train, evaluate and save, as `main` does. Returns
    ``rc`` (0, or 2 after a non-finite loss), every step's metrics
    (``losses``: dicts of floats), every step's device ms with its batch
    and augmentation (``step_ms``, CUDA events; host ms on the CPU),
    ``render_s``,
    ``stage_s``, ``train_s``, the evals, the manifest, the peak device
    memory, and the model, the last state and batch and ``step_fn``, for a
    caller that profiles a step."""
    from rt3d_torch.apps.common import check_args
    from rt3d_torch.models.convert import save_params
    from rt3d_torch.models.postprocess import letterbox_params
    from rt3d_torch.models.yolo import YoloSeg, flat_from_model, load_weights
    from rt3d_torch.train.augment import anchor_flip_perm, photometric_augment, random_hflip
    from rt3d_torch.train.data import build_synth_dataset
    from rt3d_torch.train.eval import evaluate_weights
    from rt3d_torch.train.step import make_train_step, synth_optimizer

    check_args(args)
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    hw, input_hw = tuple(args.hw), tuple(args.input_hw)
    model = YoloSeg(variant=args.variant, num_classes=80, input_hw=input_hw)
    model = model.to(device=device, memory_format=torch.channels_last if cuda else
                     torch.contiguous_format)
    model.set_compute_dtype(torch.float32 if args.f32 else torch.bfloat16)
    meta = letterbox_params(hw, input_hw)

    print(f"rendering {args.scenes} scenes x {args.frames_per_scene} frames x 2 cams "
          f"at {hw} ...", flush=True)
    t0 = time.perf_counter()
    ds = build_synth_dataset(model, num_scenes=args.scenes,
                             frames_per_scene=args.frames_per_scene, hw=hw, seed=args.seed,
                             domain=args.domain)
    render_s = time.perf_counter() - t0
    n = len(ds["images"])
    print(f"dataset: {n} samples in {render_s:.1f}s (positives/sample mean "
          f"{ds['box_w'].sum(axis=1).mean():.1f})", flush=True)
    t0 = time.perf_counter()
    dev = stage_dataset(ds, meta, device)
    if cuda:
        torch.cuda.synchronize(device)
    stage_s = time.perf_counter() - t0
    del ds
    print(f"dataset staged on {device} in {stage_s:.2f}s", flush=True)

    warmup = args.warmup if args.warmup is not None else min(100, args.steps // 5)
    init_fn, step_fn = make_train_step(model, synth_optimizer(args.lr, warmup, args.steps))
    state = init_fn(args.seed)
    if args.resume and os.path.exists(args.resume):
        load_weights(model, args.resume)
        print(f"resumed params from {args.resume}", flush=True)

    # a horizontal flip is geometry-exact only under a symmetric letterbox pad
    can_flip = (input_hw[1] - meta.new_hw[1]) % 2 == 0
    flip_perm = torch.from_numpy(anchor_flip_perm(input_hw)).to(device) if can_flip else None

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.default_rng(args.seed + 1)
    def stamp():
        """A CUDA event recorded now on the card, the host clock on the CPU."""
        if not cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    metrics, marks, rc, last = [], [], 0, None
    t0 = time.perf_counter()
    for it in range(args.steps):
        start = stamp()
        sel = torch.from_numpy(rng.choice(n, size=args.batch, replace=False)).to(device)
        batch = {k: v.index_select(0, sel) for k, v in dev.items()}
        gen = step_generator(args.seed + 7, int(state.step), device)
        imgs = batch["images"]
        if can_flip:
            imgs, batch = random_hflip(gen, imgs, batch, flip_perm, input_hw[1])
        batch["images"] = photometric_augment(gen, imgs)
        state, m = step_fn(state, batch)
        marks.append((start, stamp()))
        metrics.append(m)
        if it % 50 == 0 or it == args.steps - 1:
            last = {k: float(v) for k, v in m.items()}
            print(f"step {it:5d}  loss {last['loss']:.4f}  cls {last['cls']:.4f}  "
                  f"box {last['box']:.4f}  proto {last['proto']:.4f}  "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
            if not all(map(math.isfinite, last.values())):
                # a non-finite loss means the parameters themselves are gone
                print("non-finite loss — aborting", flush=True)
                rc = 2
                break
    if cuda:
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0

    out = {
        "rc": rc, "losses": [{k: float(v) for k, v in m.items()} for m in metrics],
        "step_ms": [a.elapsed_time(b) if cuda else (b - a) * 1e3 for a, b in marks],
        "render_s": render_s, "stage_s": stage_s, "train_s": train_s, "samples": n,
        "peak_mib": torch.cuda.max_memory_allocated(device) / 2**20 if cuda else None,
        "model": model, "state": state, "step_fn": step_fn, "batch": batch,
    }
    if rc:
        return out

    # ---- evaluation: the pipeline's own detections vs the analytic truth ----
    # on the hard held-out family whenever the model saw hard scenes, the
    # easy family beside it
    primary = "easy" if args.domain == "easy" else "hard"
    flat = flat_from_model(model)
    ev = dict(variant=args.variant, hw=hw, input_hw=input_hw, num_frames=args.eval_frames,
              seed=args.seed + 777, device=device)
    stats = evaluate_weights(flat, domain=primary, **ev)
    print(f"eval[{primary}]:", json.dumps(stats), flush=True)
    stats_easy = stats
    if primary != "easy":
        stats_easy = evaluate_weights(flat, domain="easy", **ev)
        print("eval[easy]:", json.dumps(stats_easy), flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_params({k: v.astype(np.float16) for k, v in flat.items()}, args.out)
    manifest = {
        "variant": args.variant, "input_hw": list(input_hw), "train_hw": list(hw),
        "steps": args.steps, "batch": args.batch, "lr": args.lr, "warmup": warmup,
        "scenes": args.scenes, "seed": args.seed, "domain": args.domain,
        "final_metrics": last, "eval": stats, "eval_easy": stats_easy, "dtype": "float16",
        "classes": [39, 41] if args.domain == "easy" else [39, 41, 73, 64],
        "data": "rt3d_torch.train.data.build_synth_dataset (analytic scene)",
    }
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)", flush=True)
    out.update(eval=stats, eval_easy=stats_easy, manifest=manifest)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    return train(parse_args(argv))["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
