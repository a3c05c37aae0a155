"""The check judges a mask model that carries state from frame to frame
(`PipelineState.mask_state`, `masks_with_state`), on the CPU over the small cell: the program's driver steps its frames, and a toy
mask model's state is added to the records it kept. The toy's state is, per
(camera, tracker slot), a ring of the last K mask areas of the slot's track,
a write index and the slot's track id; its masks are the cell's own, so the
stateless numbers stay sound. The program keeps the ring in bfloat16, the
reference in float32.

It also holds the stateless cells to the parent's behaviour: `compare` over
the same records gives exactly the numbers that the harness gave before it
learned of mask state, with neither new number."""

import dataclasses
import math
import os
from typing import Any, Optional, Tuple

import pytest
import torch

from bench_port import check, drive, faults, spec
from bench_port.reference.pipeline.step import PipelineState as RefPipelineState
from bench_port.reference.tracking.bytetrack import EMPTY
from bench_port.run import build_program, rendered_frames
from bench_port.synthetic import EasyScene, cycle

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CELL = "small_2cam.objects4"
SEED = 2**31 + 99
FRAMES = 5
RING = 4
# `mask_state_rel` that a sound run stays under: the program's bfloat16 ring
# against the reference's float32 one rounds by at most 2^-9 relative
REL_LIMIT = 0.01
# `compare` over FRAMES frames of the driver from SEED, recorded with the
# harness before `mask_state` existed, the program as configured (float32 on
# the CPU, so the reference's equal) and with the control's int8 path: the
# numbers that every stateless cell's limits read
STATELESS = dict(
    det_unpaired=0, box_px_med=0.0, score_med=0.0, score_max=0.0, coeff_rel_med=0.0,
    coeff_off_share=0.0, obj_voxels=0.0, track_ids_diff=0, tracker_state_diff=0,
    fused_diff=0, workspace_diff=0, accum_diff=0)
STATELESS_CONTROL = dict(
    det_unpaired=20, box_px_med=0.32305145263671875, score_med=0.004425048828125,
    score_max=0.5288601517677307, coeff_rel_med=0.13189082592725754, coeff_off_share=1.0,
    obj_voxels=0.012052593133674214, track_ids_diff=0, tracker_state_diff=0, fused_diff=0,
    workspace_diff=0, accum_diff=0)


@dataclasses.dataclass
class RingState:
    areas: torch.Tensor     # (C, S, K) float: the last K mask areas of the slot's track
    write: torch.Tensor     # (C, S) int64: the ring's next write index
    track_id: torch.Tensor  # (C, S) int32: the slot's track id, -1 when empty


@dataclasses.dataclass
class PipelineState:
    """The program's state with a mask state (the port's has none yet)."""

    trackers: Tuple[Any, ...]
    prev_gray: torch.Tensor
    accum: Any
    mask_state: Optional[RingState] = None


def ring_init(cameras, slots, dtype) -> RingState:
    return RingState(areas=torch.zeros((cameras, slots, RING), dtype=dtype),
                     write=torch.zeros((cameras, slots), dtype=torch.int64),
                     track_id=torch.full((cameras, slots), -1, dtype=torch.int32))


def ring_step(ring: RingState, trackers, track_ids, valid, areas, dtype,
              slot_shift=0, area_scale=1.0) -> RingState:
    """The ring after a frame: a slot whose track changed starts empty; each
    valid tracked detection's area goes into its track's slot (or the slot
    `slot_shift` further on) at the write index, which moves on."""
    ring_areas = ring.areas.float().clone()
    write, tid = ring.write.clone(), ring.track_id.clone()
    for c, ts in enumerate(trackers):
        ids = torch.where(ts.state != EMPTY, ts.track_id, -1).to(torch.int32)
        fresh = ids != tid[c]
        ring_areas[c][fresh] = 0.0
        write[c][fresh] = 0
        tid[c] = ids
        for d in range(track_ids.shape[1]):
            t = int(track_ids[c, d])
            hit = torch.nonzero(ids == t).flatten()
            if not bool(valid[c, d]) or t < 0 or hit.numel() == 0:
                continue
            s = (int(hit[0]) + slot_shift) % ids.shape[0]
            ring_areas[c, s, write[c, s]] = float(areas[c, d]) * area_scale
            write[c, s] = (write[c, s] + 1) % RING
    return RingState(areas=ring_areas.to(dtype), write=write, track_id=tid)


class StatefulReference:
    """The small cell's reference with the toy as its mask model."""

    def __init__(self, ref):
        self.ref = ref

    def __getattr__(self, name):
        return getattr(self.ref, name)

    def init_state(self):
        state = self.ref.init_state()
        return dataclasses.replace(state, mask_state=ring_init(
            len(state.trackers), state.trackers[0].track_id.shape[0], torch.float32))

    def masks_with_state(self, ctx, det, track_ids, trackers, mask_state):
        masks = self.ref.masks(ctx, det)
        ring = dataclasses.replace(mask_state, areas=mask_state.areas.float())
        return masks, ring_step(ring, trackers, track_ids, det.valid,
                                masks.sum((2, 3)).float(), torch.float32)


class ToyProgram:
    """The toy mask model's step over the program's recorded frames, as a
    pipeline that `bench_port.faults` can break: `step` hands on each
    recorded frame's state with the ring after it."""

    def __init__(self, run, lost_after=None, **wrong):
        self.run, self.lost_after, self.wrong = run, lost_after, wrong

    def init_state(self):
        state = self.run["kept"][0].after
        return PipelineState(**{f.name: getattr(state, f.name) for f in dataclasses.fields(state)},
                             mask_state=ring_init(len(state.trackers),
                                                  state.trackers[0].track_id.shape[0],
                                                  torch.bfloat16))

    def step(self, state, rgb, depth, calib, stage=None):
        k = self.run["kept"][rgb]  # the frame's index stands in for its images
        ring = None if self.lost_after is not None and rgb > self.lost_after else ring_step(
            state.mask_state, k.after.trackers, k.outputs.track_ids, k.outputs.detections.valid,
            self.run["areas"][k.frame], torch.bfloat16, **self.wrong)
        fields = {f.name: getattr(k.after, f.name) for f in dataclasses.fields(k.after)}
        return PipelineState(**fields, mask_state=ring), k.outputs


def stateful_kept(run, fault=None, lost_after=None, **wrong):
    """The run's records with the toy program's states in place of the
    driver's: each frame from the state the toy step handed on (None after
    frame `lost_after`)."""
    prog = ToyProgram(run, lost_after, **wrong)
    if fault is not None:
        fault(prog)
    state, kept = prog.init_state(), []
    for g, k in enumerate(run["kept"]):
        after, out = prog.step(state, g, None, None)
        kept.append(drive.Kept(k.frame, None if g == 0 else state, after, out))
        state = after
    return kept


class Seen:
    """An architecture's `ExtraNumbers` that records what `add` is given."""

    def __init__(self):
        self.calls = []

    def add(self, ref, ctx, masks, outputs, **state):
        self.calls.append(state)

    def numbers(self):
        return dict(seen_frames=len(self.calls))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as the frozen numbers were recorded: the float32
    reference's last bits depend on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drive(control: bool):
    """FRAMES frames of the small cell through the program's driver from
    SEED, every one kept (the reservoir holds them all), with the areas of
    the program's masks of each frame, and the cell's reference."""
    from rt3d_torch.runtime.driver import PipelineDriver

    cell = spec.workload(CELL, DATA)
    traffic = cell["traffic"]
    scene = EasyScene(traffic["cameras"], traffic["objects"], traffic["scene_seed"],
                      tuple(traffic["hw"]))
    frames = rendered_frames(scene, traffic)
    pipe, weights = build_program(cell, scene, "cpu", control, frames)
    areas, masks = [], pipe.masks

    def recorded(ctx, det):
        out = masks(ctx, det)
        areas.append(out[0].sum((2, 3)).float())
        return out
    pipe.masks = recorded
    driver = PipelineDriver(pipe, mode="fused", pipeline_depth=traffic["pipeline_depth"],
                            frames_per_dispatch=1)
    source = drive.ReplaySource(frames, SEED % cycle(len(frames)))
    recorder = drive.Recorder(driver, source, FRAMES, SEED)
    recorder.open, recorder.close = 0.0, math.inf
    drive.run_frames(driver, source, recorder, 0, FRAMES)
    kept = sorted(recorder.kept, key=lambda k: k.frame)
    assert [k.frame for k in kept] == list(range(FRAMES)) and len(areas) == FRAMES
    ref = check.reference_pipeline(cell["arch"], cell["config_spec"], scene.cameras(), "cpu",
                                   weights)
    return dict(kept=kept, areas=areas, frames_of=source.frame, ref=ref, pipe=pipe)


@pytest.fixture(scope="module")
def run():
    return _drive(control=False)


@pytest.fixture(scope="module")
def control_run():
    return _drive(control=True)


def _compare(run, kept, extra=None):
    return check.compare(kept, run["frames_of"], StatefulReference(run["ref"]), extra)


@pytest.mark.parametrize("which, expected", [("run", STATELESS),
                                             ("control_run", STATELESS_CONTROL)])
def test_stateless_numbers_are_the_parents(request, which, expected):
    drove = request.getfixturevalue(which)
    numbers = check.compare(drove["kept"], drove["frames_of"], drove["ref"])
    assert list(numbers) == list(expected)  # neither mask-state number among them
    assert numbers == pytest.approx(expected, rel=1e-6, abs=0)
    assert {type(v) for v in numbers.values()} <= {int, float}


def test_a_sound_stateful_run_is_correct(run):
    kept = stateful_kept(run)
    assert any(bool((k.after.mask_state.write > 0).any()) for k in kept)  # the ring is written
    seen = Seen()
    numbers = _compare(run, kept, seen)
    assert numbers["mask_state_int_diff"] == 0
    assert numbers["mask_state_rel"] <= REL_LIMIT
    assert {k: numbers[k] for k in STATELESS} == STATELESS
    assert numbers["seen_frames"] == FRAMES
    assert all(set(c) == {"mask_state"} for c in seen.calls)
    assert seen.calls[0]["mask_state"].areas.dtype == torch.float32  # the reference's initial ring
    assert seen.calls[1]["mask_state"].areas.dtype == torch.bfloat16  # the program's, as it is


@pytest.mark.parametrize("fault, wrong, number", [
    (faults.mask_state_frozen, {}, "mask_state_int_diff"),
    (None, dict(area_scale=1.5), "mask_state_rel"),
    (None, dict(slot_shift=1), "mask_state_int_diff"),
])
def test_a_wrong_mask_state_is_not_correct(run, fault, wrong, number):
    numbers = _compare(run, stateful_kept(run, fault, **wrong))
    limit = REL_LIMIT if number == "mask_state_rel" else 0
    assert numbers[number] > limit
    assert {k: numbers[k] for k in STATELESS} == STATELESS  # the masks themselves are sound


def test_mask_state_frozen_refuses_a_stateless_program(run):
    with pytest.raises(ValueError, match="no mask state"):
        faults.mask_state_frozen(run["pipe"])
    assert "mask_state_frozen" in faults.for_cell(spec.workload(CELL, DATA))


def test_a_missing_field_takes_the_reference_default():
    state = RefPipelineState(trackers=(), prev_gray=torch.zeros(1), accum=None)
    classes = check.reference_classes()
    assert check.to_reference(state, classes).mask_state is None

    @dataclasses.dataclass
    class PipelineState:  # noqa: F811 - the program's name, a field the reference lacks
        trackers: tuple
        prev_gray: torch.Tensor
        accum: Any
        bank: torch.Tensor

    with pytest.raises(ValueError, match="bank"):
        check.to_reference(PipelineState((), torch.zeros(1), None, torch.zeros(1)), classes)
    with pytest.raises(ValueError, match="no class"):
        check.to_reference(RingState(torch.zeros(1), torch.zeros(1), torch.zeros(1)), classes)


@pytest.mark.parametrize("sampled, which", [(range(FRAMES), "out of"),
                                            ([0, 1, 3, 4], "into")])
def test_a_mask_state_dropped_is_not_correct(run, sampled, which):
    """The program hands on None after frame 1: whether or not the frame
    that drops it is sampled, the check refuses the run, since the
    reference, not the program, says that the mask model has state."""
    kept = stateful_kept(run, lost_after=1)
    with pytest.raises(ValueError, match=f"no mask state {which}"):
        _compare(run, [kept[g] for g in sampled])


def test_the_reference_mask_state_names_its_classes():
    @dataclasses.dataclass
    class TrackerState:
        x: torch.Tensor

    @dataclasses.dataclass
    class Bank:
        ring: RingState
        slots: Tuple[Any, ...]

    ring = ring_init(1, 2, torch.float32)
    classes = check.reference_classes(Bank(ring, (ring, torch.zeros(1))))
    assert classes["RingState"] is RingState and classes["Bank"] is Bank
    assert "RingState" not in check.reference_classes()
    with pytest.raises(ValueError, match="TrackerState"):
        check.reference_classes(Bank(ring, (TrackerState(torch.zeros(1)),)))
    Other = dataclasses.make_dataclass("RingState", [("x", torch.Tensor)])
    with pytest.raises(ValueError, match="RingState"):
        check.reference_classes((ring, Other(torch.zeros(1))))
