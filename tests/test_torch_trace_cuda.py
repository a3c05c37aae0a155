"""The step's own count of host syncs against CUDA's sync detection, on the
card.

Marked ``cuda``; each test skips without a CUDA device (this module imports
no JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_trace_cuda.py

For one steady step of a preset, driven through `Pipeline.step` (the
driver's wait for the outputs is no part of the step), every warning that
``torch.cuda.set_sync_debug_mode("warn")`` raises is one place where the
host waited on the device. Their number must equal the step's `host_syncs`
(`rt3d_torch.runtime.trace`), site for site in total. Warnings are recorded
with the filter "always": the default filter shows a warning once per code
location and would undercount a sync made once a round.
"""

import collections
import dataclasses
import warnings

import pytest
import torch

from rt3d_torch.pipeline.presets import preset_config, preset_source, preset_weights
from rt3d_torch.pipeline.step import build_pipeline
from rt3d_torch.runtime import trace

pytestmark = pytest.mark.cuda

WARM = 3  # steps before the counted one: kernels built, tracks confirmed


@pytest.mark.parametrize("preset,assignment", [
    ("2cam", "greedy"), ("stretch_4cam_1mm", "greedy"), ("2cam_botsort", "greedy"),
    ("2cam_deepsort", "greedy"), ("2cam", "refined"), ("2cam", "exact")])
def test_host_syncs_equal_cudas_sync_count(preset, assignment):
    """The benchmark's two presets, the other trackers, and ByteTrack's
    refined and exact solvers (the exact one reads back every iteration)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src = preset_source(preset, WARM + 1)
    cfg = preset_config(preset, src)
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, assignment=assignment))
    check_one_step(preset, assignment, cfg, src)


def test_sam_step_host_syncs_equal_cudas_sync_count():
    """The 2cam preset with SAM ViT-H as its mask model: SAM's encoder and
    mask stage add no host wait that the step does not count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    src = preset_source("2cam", WARM + 1)
    cfg = preset_config("2cam", src)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, mask_model="sam_vit_h"))
    check_one_step("2cam", "greedy", cfg, src)


def check_one_step(preset, assignment, cfg, src):
    """Warm `cfg`'s pipeline up on `WARM` frames of `src`, then count one
    step's host syncs both ways and hold them equal."""
    pipe = build_pipeline(cfg, weights=preset_weights(preset), device="cuda")
    state, calib = pipe.init_state(), pipe.calib()
    frames = []
    for i in range(WARM + 1):
        pkt = src.get(i)
        frames.append((torch.from_numpy(pkt.rgb).cuda(), torch.from_numpy(pkt.depth).cuda()))
    for rgb, depth in frames[:WARM]:
        state, _ = pipe.step(state, rgb, depth, calib)
    torch.cuda.synchronize()
    trace.clear()
    trace.enable()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                pipe.step(state, *frames[WARM], calib)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        trace.disable()
    # the mode's own first warning ("a prototype feature ...") is no sync
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    rec = trace.records()[-1]
    where = collections.Counter(f"{w.filename}:{w.lineno}" for w in syncs)
    print(f"{preset} {assignment}: {len(syncs)} sync warnings, host_syncs {rec['host_syncs']}; "
          f"warned at {dict(where)}")
    assert sum(rec["host_syncs"].values()) == len(syncs), (rec["host_syncs"], dict(where))
    assert len(syncs) > 0
