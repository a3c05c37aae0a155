"""Camera-stream sharding over a process group (port of
`rt3d/parallel/multicam.py`): a block of cameras per rank.

The reference processes its two cameras back-to-back on one GPU
(`2cams_mask_gpu.py:272-291` — two sequential `model.track` calls). Here
each rank runs the full per-camera pipeline on its own cameras; the only
communication is ONE all-gather of the compact per-object buffers and the
workspace voxels (a few hundred KB) right before fusion, which then runs
replicated on every rank, as the JAX package's `shard_map` step does.

On a machine with several GPUs, `main` runs a preset's sharded step over
the ranks of a `torchrun` job, one GPU a rank:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m rt3d_torch.parallel.multicam --preset 2cam --frames 6
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from rt3d_torch.geometry.fusion import ObjectSet
from rt3d_torch.geometry.ops import PointBuffer
from rt3d_torch.pipeline.step import (
    CameraCalib, FrameOutputs, Pipeline, PipelineState,
)


def _all_gather(x: torch.Tensor, world: int, group) -> torch.Tensor:
    """Rank-ordered concatenation of every rank's `x` on its leading axis
    (`jax.lax.all_gather(..., tiled=True)`). Bool tensors travel as uint8:
    collective backends differ on bool."""
    src = x.contiguous()
    wire = src.view(torch.uint8) if src.dtype == torch.bool else src
    out = wire.new_empty((world * wire.shape[0], *wire.shape[1:]))
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.view(torch.bool) if src.dtype == torch.bool else out


@dataclass
class ShardedStep:
    """The camera-sharded step of one rank: cameras ``[lo, hi)`` of the
    pipeline's rig, ``hi - lo = C / world``.

    Call it as ``step(state, rgb, depth, calib) -> (state, FrameOutputs)``
    with the rank's camera slices (``rgb[lo:hi]``, ``depth[lo:hi]``,
    `calib()`) and a state from `init_state()`. Per-camera state (the
    trackers, GMC's grey frames) holds the rank's cameras only; the
    workspace accumulator is global and replicated. Per-camera outputs
    (detections, track IDs, `per_camera_objects`, SAM's `low_res_logits`)
    are the rank's; fused outputs (objects, `objects_flat`, workspace,
    overflow) are the same on every rank, and equal the single-device
    `Pipeline.step`'s with ``workspace_sor`` off: as in the JAX package's
    sharded step, the gathered workspace goes to subtraction without the
    workspace SOR."""

    pipeline: Pipeline
    lo: int
    hi: int
    world: int
    group: Optional[dist.ProcessGroup] = None

    def init_state(self) -> PipelineState:
        full = self.pipeline.init_state()
        return PipelineState(trackers=full.trackers[self.lo:self.hi],
                             prev_gray=full.prev_gray[self.lo:self.hi], accum=full.accum)

    def calib(self) -> CameraCalib:
        full = self.pipeline.calib()
        return CameraCalib(**{f.name: getattr(full, f.name)[self.lo:self.hi]
                              for f in fields(CameraCalib)})

    def __call__(self, state: PipelineState, rgb: torch.Tensor, depth: torch.Tensor,
                 calib: CameraCalib) -> Tuple[PipelineState, FrameOutputs]:
        pipe, world, group = self.pipeline, self.world, self.group
        if rgb.shape[0] != self.hi - self.lo:
            raise ValueError(f"rank holds cameras [{self.lo}, {self.hi}); got {rgb.shape[0]}")
        with torch.no_grad():
            # per-camera work on the rank's cameras
            images = pipe.preprocess(rgb)
            det, ctx, emb = pipe.detect(images)
            state, ids = pipe.track(state, det, det_emb=emb, images=images)
            masks, low_res = pipe.masks(ctx, det)
            objs, obj_ovf = pipe.object_clouds(depth, masks, det, ids, calib)
            ws, ws_ovf = pipe.workspace_clouds(depth, calib)

            # the one collective: every camera's object sets and workspace voxels
            objs_all = ObjectSet(*(_all_gather(getattr(objs, f.name), world, group)
                                   for f in fields(ObjectSet)))
            ws_all = PointBuffer(points=_all_gather(ws.points, world, group).reshape(-1, 3),
                                 valid=_all_gather(ws.valid, world, group).reshape(-1))

            # replicated fusion, subtraction and accumulation
            fused, flat, flat_ovf = pipe.fuse(objs_all)
            ws_out = pipe.subtract(ws_all, flat)
            state, ws_out, acc_ovf = pipe.accumulate(state, ws_out)
            local_ovf = obj_ovf.sum(dtype=torch.int32) + ws_ovf.sum(dtype=torch.int32)
            dist.all_reduce(local_ovf, group=group)
            overflow = local_ovf + flat_ovf.to(torch.int32) + acc_ovf
        return state, FrameOutputs(
            detections=det, track_ids=ids, objects=fused, objects_flat=flat,
            workspace=ws_out, per_camera_objects=objs, overflow=overflow,
            low_res_logits=low_res)


def make_sharded_step(pipeline: Pipeline, group: Optional[dist.ProcessGroup] = None
                      ) -> ShardedStep:
    """The step of this rank of `group` (default: the whole initialized
    process group): rank r holds cameras ``[r C / W, (r + 1) C / W)``, the
    order of the JAX package's tiled all-gather. The pipeline (a quantized
    one too) is replicated: every rank builds the same. Fails when the
    cameras do not split evenly over the ranks, as `shard_map` does."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    c = pipeline.cfg.rig.num_cameras
    if c % world:
        raise ValueError(f"{c} cameras do not split evenly over {world} ranks")
    per = c // world
    return ShardedStep(pipeline, rank * per, (rank + 1) * per, world, group)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """A preset's sharded step over the ranks of a `torchrun` job (NCCL,
    the rendezvous `torchrun` sets up, the GPU of each rank's
    ``LOCAL_RANK``): every rank builds the preset's pipeline and steps its
    block of cameras over the preset's synthetic frames; rank 0 prints
    each frame's device ms and fused outputs."""
    import argparse
    import os

    from rt3d_torch.pipeline.presets import PRESETS, synthetic_preset

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--preset", default="2cam", choices=sorted(PRESETS))
    p.add_argument("--frames", type=int, default=6)
    args = p.parse_args(argv)
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", device_id=device)
    try:
        pipe, src = synthetic_preset(args.preset, args.frames, device=device)
        step = make_sharded_step(pipe)
        state, calib = step.init_state(), step.calib()
        for i in range(args.frames):
            pkt = src.get(i)
            rgb = torch.from_numpy(pkt.rgb[step.lo:step.hi]).to(device)
            depth = torch.from_numpy(pkt.depth[step.lo:step.hi]).to(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, out = step(state, rgb, depth, calib)
            b.record()
            b.synchronize()
            if dist.get_rank() == 0:
                print(f"frame {i}: {a.elapsed_time(b):.2f} ms device clock on rank 0 "
                      f"(cameras [{step.lo}, {step.hi}) of {pipe.cfg.rig.num_cameras}, "
                      f"{step.world} ranks); fused objects {int(out.objects.present.sum())}, "
                      f"object points {int(out.objects_flat.valid.sum())}, workspace points "
                      f"{int(out.workspace.valid.sum())}, overflow {int(out.overflow)}",
                      flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
