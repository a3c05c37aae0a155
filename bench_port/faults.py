"""Faults planted underneath the timed path, for the tests that see
`correct` come out false and for the readings on the card that set the
limits (`control.py --fault`). Each `fault(pipe)` breaks the program's
pipeline `pipe` before the driver is built and returns a callable that
undoes what it did outside `pipe`. Those in `FAULTS` break any
architecture's step; an architecture module (`arch/<name>.py`) may bring
its own in a dict `FAULTS`, which `for_cell` joins to them for a cell of
that architecture."""

from __future__ import annotations

import dataclasses

import torch


def state_unchanged(pipe):
    """The step returns the state it was given."""
    step = pipe.step

    def f(state, rgb, depth, calib, stage=None):
        return state, step(state, rgb, depth, calib, stage=stage)[1]
    pipe.step = f
    return lambda: None


def half_the_cameras(pipe):
    """The second half of the cameras is left out: the step sees no depth
    there, and the rest stands for the whole rig."""
    step = pipe.step

    def f(state, rgb, depth, calib, stage=None):
        depth = depth.clone()
        depth[depth.shape[0] // 2:] = 0.0
        return step(state, rgb, depth, calib, stage=stage)
    pipe.step = f
    return lambda: None


def detections_dropped(pipe):
    """Detect leaves out the second half of the cameras: their detections
    come out invalid, and every later stage runs on what is left."""
    detect = pipe.detect

    def f(images):
        det, protos, emb = detect(images)
        valid = det.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return dataclasses.replace(det, valid=valid), protos, emb
    pipe.detect = f
    return lambda: None


def k2_self_in_window(pipe):
    """K2's window takes in the pixel itself (its offsets start at (0, 0)),
    so every pixel's mask bits count as seen before and are cleared."""
    from rt3d_torch.geometry import ops

    orig = ops.window_prev_or

    def f(kg, wg, dy_max=4, dx_max=6, plain=False):
        return orig(kg, wg, dy_max, dx_max, plain=plain) | wg
    ops.window_prev_or = f

    def undo():
        ops.window_prev_or = orig
    return undo


def workspace_voxel_moved(pipe):
    """One answer altered where it is produced: the first valid point of the
    published workspace moves by one voxel."""
    step = pipe.step

    def f(state, rgb, depth, calib, stage=None):
        state, out = step(state, rgb, depth, calib, stage=stage)
        pts = out.workspace.points.clone()
        i = int(torch.nonzero(out.workspace.valid)[0])
        pts[i, 0] += pipe.cfg.pipeline.voxel_size
        return state, dataclasses.replace(out, workspace=dataclasses.replace(out.workspace, points=pts))
    pipe.step = f
    return lambda: None


def mask_state_frozen(pipe):
    """The step hands on the mask state it was given, and is sound
    otherwise. A program whose state holds no mask state is refused here:
    the fault would change nothing."""
    if getattr(pipe.init_state(), "mask_state", None) is None:
        raise ValueError("mask_state_frozen: the program's PipelineState holds no mask state")
    step = pipe.step

    def f(state, rgb, depth, calib, stage=None):
        new, out = step(state, rgb, depth, calib, stage=stage)
        return dataclasses.replace(new, mask_state=state.mask_state), out
    pipe.step = f
    return lambda: None


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_cameras, detections_dropped,
                                  k2_self_in_window, workspace_voxel_moved, mask_state_frozen)}


def for_cell(cell):
    """The faults above and those of the cell's architecture module
    (`cell["arch"]`, as `bench_port.spec.workload` attaches it), by name."""
    own = getattr(cell["arch"], "FAULTS", {})
    if set(own) & set(FAULTS):
        raise ValueError(f"faults named twice: {sorted(set(own) & set(FAULTS))}")
    return {**FAULTS, **own}
