"""Rank processes for `tests/test_torch_parallel.py`: the port's
camera-sharded step and dp x fsdp train step over a gloo process group of
spawned CPU processes, each with one torch thread. The sharded step and
its single-device references run with oneDNN off: oneDNN picks its
convolution by batch size, where the reference convolution gives each
image the same bits in a batch of 1 or of 2.

`run_ranks(fn, world, *args)` starts `world` processes, each running
``fn(rank, world, *args)`` inside an initialized process group (a file
store in a fresh directory: no port), and returns the ranks' results in
rank order. Every wait has a timeout, and every process is killed if it
outlives it, so a hang fails one test. This module imports no JAX, so
the ranks start quickly, and holds no test.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 240.0


def host_tree(x):
    """Tensors of a tree of dataclasses, tuples, lists and dicts as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    if isinstance(x, (tuple, list)):
        return type(x)(host_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: host_tree(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return {f.name: host_tree(getattr(x, f.name)) for f in fields(x)}
    return x


def _entry(fn, rank, world, store, args, results):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=120))
        try:
            results.put((rank, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, RuntimeError(f"rank {rank}:\n{traceback.format_exc()}")))


def run_ranks(fn, world: int, *args, timeout: float = TIMEOUT_S):
    """``[fn(r, world, *args) for r in range(world)]``, each in its own
    spawned process of a gloo group; raises the first rank's failure."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rt3d_dist_")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, os.path.join(tmp, "store"), args,
                                              results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < world:
            try:
                rank, res = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"{world - len(out)} of {world} ranks gave no result in "
                                   f"{timeout} s") from None
            if isinstance(res, BaseException):
                raise res
            out[rank] = res
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the camera-sharded step
# ---------------------------------------------------------------------------


@dataclass
class ShardCase:
    """One config of the sharded-step tests: a `Config` dict, the weights,
    the activation scales of a quantized model (or None), the frames."""

    name: str
    cfg: dict
    weights: str
    act_scales: dict
    rgb: np.ndarray     # (frames, C, H, W, 3)
    depth: np.ndarray   # (frames, C, H, W)


def build(case: ShardCase):
    from rt3d_torch.config import Config
    from rt3d_torch.models import quant
    from rt3d_torch.pipeline.step import build_pipeline

    pipe = build_pipeline(Config.from_dict(case.cfg), weights=case.weights, device="cpu")
    if case.act_scales is not None:
        quant.quantize_pipeline(pipe, case.weights, (), case.act_scales)
    return pipe


def sharded_run(cases, group):
    """Each case's sharded step over its frames on `group`: per frame the
    outputs and the state after it, as numpy; a config whose cameras do not
    split over the ranks gives the error's text."""
    from rt3d_torch.parallel import make_sharded_step

    res = {}
    for case in cases:
        pipe = build(case)
        try:
            step = make_sharded_step(pipe, group)
        except ValueError as e:
            res[case.name] = str(e)
            continue
        state, calib = step.init_state(), step.calib()
        frames = []
        for rgb, depth in zip(case.rgb, case.depth):
            state, out = step(state, torch.from_numpy(rgb[step.lo:step.hi]),
                              torch.from_numpy(depth[step.lo:step.hi]), calib)
            frames.append((host_tree(out), host_tree(state)))
        res[case.name] = {"cameras": (step.lo, step.hi), "frames": frames}
    return res


def single_run(case: ShardCase):
    """The single-process `Pipeline.step` over the case's frames, as
    `sharded_run` reports it."""
    pipe = build(case)
    state, calib = pipe.init_state(), pipe.calib()
    frames = []
    for rgb, depth in zip(case.rgb, case.depth):
        state, out = pipe.step(state, torch.from_numpy(rgb), torch.from_numpy(depth), calib)
        frames.append((host_tree(out), host_tree(state)))
    return frames


def parallel_run(rank, world, cases, references, train):
    """The 4 ranks' work of `tests/test_torch_parallel.py`: the dp 2 x fsdp
    2 train step (`mesh_train_run(*train)`) on all four; then, with oneDNN
    off, the sharded step of every case on the group of ranks 0 and 1,
    while ranks 2 and 3 step `references` (pairs of a rank and a case) on
    one device."""
    res = mesh_train_run(*train)
    out = {"train": res if rank == 0 else None}
    pair = dist.new_group([0, 1])
    with torch.backends.mkldnn.flags(enabled=False):
        if rank < 2:
            out["sharded"] = sharded_run(cases, pair)
        else:
            out["single"] = {c.name: single_run(c) for r, c in references if r == rank}
    return out


# ---------------------------------------------------------------------------
# the dp x fsdp train step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SGD:
    """Plain SGD with the interface `make_train_step` asks of its
    optimizer (`rt3d_torch.train.step.AdamW`'s)."""

    lr: float = 1e-3

    def init(self, params):
        return {"count": torch.zeros((), dtype=torch.int64)}

    def make(self, params):
        return torch.optim.SGD(list(params.values()), lr=self.lr)

    def step(self, opt, params, grads, state, norms=None):
        for p, g in zip(params.values(), grads):
            p.grad = g
        opt.step()
        for p in params.values():
            p.grad = None
        state["count"] += 1


def mesh_train_run(model_kw, flat, batches, chain):
    """On a dp 2 x fsdp 2 mesh: one step of the trainer's chain
    (`synth_optimizer(**chain)`) on each of `batches` in turn, from the
    JAX-layout parameters `flat`, each step's metrics and whole
    parameters; then 2 SGD steps on the first batch from the seed-0 draw,
    each step's loss. Also the parameters' placements, those of
    `replicated` and `batch_sharding`, and the errors of a mesh larger and
    one smaller than the group and of one whose axes are not
    ``("dp", "fsdp")``."""
    from rt3d_torch.models.yolo import YoloSeg, state_dict_from_npz
    from rt3d_torch.parallel import make_mesh
    from rt3d_torch.parallel.mesh import batch_sharding, replicated
    from rt3d_torch.train.step import TrainState, make_train_step, synth_optimizer

    refusals = []
    for sizes in ({"dp": 4, "fsdp": 2}, {"dp": 2}, {"fsdp": 2, "dp": 2}):
        try:
            make_train_step(YoloSeg(**model_kw), mesh=make_mesh(sizes, device_type="cpu"))
        except ValueError as e:
            refusals.append(str(e))
    mesh = make_mesh({"dp": 2, "fsdp": 2}, device_type="cpu")
    layouts = [repr(replicated(mesh)), repr(batch_sharding(mesh)),
               repr(batch_sharding(mesh, ("dp", "fsdp")))]
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    init_fn, step_fn = make_train_step(YoloSeg(**model_kw), synth_optimizer(**chain), mesh=mesh)
    state = init_fn(0)
    state = TrainState(params=state_dict_from_npz(flat), opt_state=state.opt_state,
                       step=state.step)
    out = {"chain": [], "refusals": refusals, "layouts": layouts}
    for batch in batches:
        state, m = step_fn(state, batch)
        full = {k: p.detach().full_tensor().numpy().copy() for k, p in state.params.items()}
        out["chain"].append(({k: float(v) for k, v in m.items()}, full))
    out["placements"] = {k: [repr(pl) for pl in p.placements] for k, p in state.params.items()}
    out["count"] = int(state.opt_state["count"])
    init_fn, step_fn = make_train_step(YoloSeg(**model_kw), SGD(1e-3), mesh=mesh)
    state = init_fn(0)
    out["sgd"] = []
    for _ in range(2):
        state, m = step_fn(state, batches[0])
        out["sgd"].append(float(m["loss"]))
    out["step"] = int(state.step)
    return out
