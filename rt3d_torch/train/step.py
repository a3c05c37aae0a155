"""The train step (port of `rt3d/train/step.py`) and the optimizers of the
JAX package's training, to optax's semantics.

`TrainState` holds the model's parameters, the optimizer's state and the
step as tensors, so `rt3d_torch.runtime.checkpoint.save_pytree` writes it
whole and `load_pytree` restores it: a resumed run continues the same
trajectory. Its tensors are the live ones (the model's parameters, the
optimizer's moments): `step_fn` updates them in place and returns the
state; a state that `load_pytree` built is copied into them by its first
step.

`AdamW` is the optimizer: `torch.optim.AdamW` with the gradient
transformations the JAX trainer chains before it, in optax's order and
arithmetic:

* ``zero_nans`` (`optax.zero_nans`): NaN gradient elements become 0, each
  on its own (an inf stays), before the norm is taken;
* ``clip_norm`` (`optax.clip_by_global_norm`): when the global norm is at
  least the limit, every gradient becomes ``g / norm * limit``, with no
  epsilon; below it the gradients pass unchanged;
* `optax.adamw` with `lr` a number or a schedule of the update count
  (starting at 0, so a warm-up from 0 makes the first update move
  nothing); it decays every parameter, biases included, by ``lr * wd``.

With a dp x fsdp mesh (`rt3d_torch.parallel.make_mesh`), `make_train_step`
shards the parameters and the optimizer's moments over ``fsdp`` by the JAX
package's rule (`rt3d_torch.parallel.fsdp_placements`) through FSDP2
(``fully_shard`` on the mesh: replicated over ``dp``, sharded over
``fsdp``), and the global batch over every rank. Each step computes what
the single-device step computes on the global batch, as JAX's `jit` over
a dp-sharded batch does: the loss's counts are summed over the ranks
before they divide (`seg_detection_loss`'s ``total``), the gradients are
summed, not averaged, over the ranks, the clip reads the norm of the whole
gradient, and the metrics are the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from rt3d_torch.models.yolo import YoloSeg, init_random
from rt3d_torch.train.loss import seg_detection_loss


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """`optax.warmup_cosine_decay_schedule` in float32, as optax computes
    it: a linear ramp from `init_value` to `peak_value` over
    `warmup_steps` updates, then a cosine decay to `end_value` at
    `decay_steps` (warm-up included)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = f32(min(count - warmup_steps, decay_steps - warmup_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay_steps - warmup_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


@dataclass(frozen=True)
class AdamW:
    """AdamW after optional NaN zeroing and global-norm clipping (the
    module docstring gives the semantics). ``AdamW(1e-4)`` is
    `optax.adamw(1e-4)`; ``weight_decay=0`` makes it `optax.adam`."""

    lr: Union[float, Callable[[int], float]] = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    zero_nans: bool = False
    clip_norm: Optional[float] = None

    def learning_rate(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        """The zero state: the moments and the update count (on the
        host)."""
        return {"count": torch.zeros((), dtype=torch.int64),
                "mu": {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                       for k, p in params.items()},
                "nu": {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                       for k, p in params.items()}}

    def _transform(self, grads, norms):
        """Zero the NaNs, then clip by the global norm, in place."""
        if self.zero_nans:
            for g in grads:
                g.masked_fill_(torch.isnan(g), 0.0)
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(norms(grads)))
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.clip_norm))

    def step(self, opt: torch.optim.AdamW, params: Dict[str, torch.Tensor],
             grads, state: dict,
             norms: Callable[[List[torch.Tensor]], List[torch.Tensor]] = torch._foreach_norm
             ) -> None:
        """One update of `params` and of `state` (in place) by `grads`,
        through `opt`, a `torch.optim.AdamW` over `params`. Sharded
        gradients (`DTensor`) are transformed on their local shards, and
        `norms` gives the whole leaves' norms from those."""
        self._transform([g.to_local() if isinstance(g, DTensor) else g for g in grads], norms)
        count = int(state["count"])
        for (k, p), g in zip(params.items(), grads):
            p.grad = g
            opt.state[p] = {"step": torch.tensor(float(count)),
                            "exp_avg": state["mu"][k], "exp_avg_sq": state["nu"][k]}
        for group in opt.param_groups:
            group["lr"] = self.learning_rate(count)
        opt.step()
        for p in params.values():
            p.grad = None
        state["count"] += 1

    def make(self, params: Dict[str, torch.Tensor]) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(params.values()), lr=self.learning_rate(0),
                                 betas=(self.b1, self.b2), eps=self.eps,
                                 weight_decay=self.weight_decay)


def synth_optimizer(lr: float, warmup: int, steps: int) -> AdamW:
    """The optimizer of `tools/train_synth.py`: zero_nans, then
    clip_by_global_norm(5.0), then adamw on a warm-up cosine schedule
    (from 0 to `lr` over `warmup` updates, down to ``lr * 0.05`` at
    `steps`), b2 0.95 (a shorter second-moment memory rides out loss
    spikes), weight decay 1e-4. The BN-folded network has no normalization
    layers; yolo11x in bf16 emitted a non-finite gradient near step 80
    without the NaN zeroing."""
    return AdamW(lr=warmup_cosine_decay_schedule(0.0, lr, warmup, steps, lr * 0.05),
                 b2=0.95, weight_decay=1e-4, zero_nans=True, clip_norm=5.0)


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: dict
    step: torch.Tensor


def make_train_step(model: YoloSeg, optimizer: Optional[AdamW] = None, mesh=None):
    """Returns (init_fn(seed) -> TrainState, step_fn(state, batch) ->
    (state, metrics)) for `model` (parameters f32; the compute dtype is the
    model's, `YoloSeg.set_compute_dtype`). `batch` holds ``images`` (B, H,
    W, 3) in [0, 1] and the targets of `seg_detection_loss`; `metrics` the
    loss and its parts, as 0-d tensors on the device.

    `init_fn` draws the model's parameters from `seed` (`init_random`;
    load weights after it to start from them) and zeroes the optimizer.

    With `mesh`, a `DeviceMesh` with axes ``("dp", "fsdp")`` over the
    whole process group, the model is sharded in place (the module
    docstring says how), every rank calls `init_fn` and `step_fn` alike,
    and `step_fn` takes the global batch on every rank and steps on its
    rank's slice (``B / world`` samples, in rank order). Its state holds
    the sharded parameters and moments (`DTensor`); a state whose
    parameters or moments are plain tensors of the full shapes (weights
    loaded on the host, say) is copied into the shards by the next
    `step_fn`."""
    optimizer = optimizer or AdamW(1e-4)
    if mesh is not None:
        return _mesh_train_step(model, optimizer, mesh)
    params = dict(model.named_parameters())
    live = {"opt": None}
    engine = optimizer.make(params)

    def init_fn(seed: int = 0) -> TrainState:
        init_random(model, seed)
        live["opt"] = optimizer.init(params)
        return TrainState(params=params, opt_state=live["opt"],
                          step=torch.zeros((), dtype=torch.int64))

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        if live["opt"] is None:
            raise RuntimeError("make_train_step: call init_fn before step_fn")
        _adopt(state, params, live["opt"])
        loss, parts = seg_detection_loss(model, batch["images"], batch)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
            torch.autograd.grad(loss, list(params.values()), allow_unused=True),
            params.values())]
        with torch.no_grad():
            optimizer.step(engine, params, grads, live["opt"])
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        return TrainState(params=params, opt_state=live["opt"], step=state.step + 1), metrics

    return init_fn, step_fn


def _adopt(state: TrainState, params: Dict[str, torch.Tensor], opt: dict) -> None:
    """Copy a state whose tensors are not the live ones (`params`, the
    optimizer state `opt`) into them."""
    with torch.no_grad():
        for k, p in params.items():
            if state.params[k] is not p:
                _copy_into(p, state.params[k])
        if state.opt_state is not opt:
            opt["count"].copy_(state.opt_state["count"])
            for part in ("mu", "nu"):
                for k, t in opt[part].items():
                    _copy_into(t, state.opt_state[part][k])


def _shard_of(full: torch.Tensor, like: DTensor) -> torch.Tensor:
    """This rank's part of `full` in the layout of the sharded `like`."""
    from rt3d_torch.parallel.mesh import local_part

    local = like.to_local()
    full = local_part(full, like.device_mesh, like.placements)
    if full.shape != local.shape:
        raise ValueError(f"shard of {tuple(full.shape)} != local {tuple(local.shape)}")
    return full.to(local.device, local.dtype)


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy `src` into `dst`; into a sharded `dst`, a whole `src` copies
    its shard."""
    if isinstance(dst, DTensor) and not isinstance(src, DTensor):
        dst.to_local().copy_(_shard_of(src, dst))
    else:
        dst.copy_(src)


def _mesh_train_step(model: YoloSeg, optimizer: AdamW, mesh):
    """`make_train_step` on a dp x fsdp mesh: FSDP2 over the whole model."""
    from torch.distributed.fsdp import fully_shard

    from rt3d_torch.parallel.mesh import batch_sharding, fsdp_placements, local_part

    if tuple(mesh.mesh_dim_names or ()) != ("dp", "fsdp"):
        raise ValueError(f"the train mesh's axes must be ('dp', 'fsdp'), "
                         f"not {mesh.mesh_dim_names}")
    fsdp_group = mesh.get_group("fsdp")
    world = mesh.size()
    # the batch is split over every rank, dp-major (JAX's P("dp") splits
    # it over dp only; the gradient is the same)
    batch_layout = batch_sharding(mesh, ("dp", "fsdp"))
    placements = fsdp_placements(model, mesh.size(1))
    by_param = {id(p): placements[name] for name, p in model.named_parameters()}
    # FSDP2 cannot replicate a parameter: the rule's replicated ones take
    # its default, dim 0 split with padding
    fully_shard(model, mesh=mesh, shard_placement_fn=lambda p: (
        by_param[id(p)] if isinstance(by_param[id(p)], Shard) else None))
    # the loss is already each slice's share of the global batch's: sum the
    # gradients (plain sums, which every backend has), divide by nothing
    model.set_gradient_divide_factor(1.0)
    model.set_force_sum_reduction_for_comms(True)
    params = dict(model.named_parameters())
    live = {"opt": None}
    engine = optimizer.make(params)

    def total(x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x)
        return x

    def norms(grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The leaves' norms from their local shards: each shard's sum of
        squares, summed over the fsdp ranks (the dp ranks hold the same)."""
        sq = torch.stack([g.float().pow(2).sum() for g in grads])
        dist.all_reduce(sq, group=fsdp_group)
        return list(sq.sqrt())

    def init_fn(seed: int = 0) -> TrainState:
        full = init_random(YoloSeg(variant=model.variant, num_classes=model.num_classes,
                                   num_mask_coeffs=model.num_mask_coeffs,
                                   input_hw=model.input_hw), seed)
        with torch.no_grad():
            for k, p in full.named_parameters():
                _copy_into(params[k], p)
        live["opt"] = optimizer.init(params)
        return TrainState(params=params, opt_state=live["opt"],
                          step=torch.zeros((), dtype=torch.int64))

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        if live["opt"] is None:
            raise RuntimeError("make_train_step: call init_fn before step_fn")
        _adopt(state, params, live["opt"])
        b = batch["images"].shape[0]
        if b % world:
            raise ValueError(f"a global batch of {b} does not split over {world} ranks")
        local = {k: local_part(v, mesh, batch_layout) for k, v in batch.items()}
        loss, parts = seg_detection_loss(model, local["images"], local, total=total)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params.values()]
        with torch.no_grad():
            optimizer.step(engine, params, grads, live["opt"], norms=norms)
        metrics = {"loss": total(loss), **{k: total(v) for k, v in parts.items()}}
        return TrainState(params=params, opt_state=live["opt"], step=state.step + 1), metrics

    return init_fn, step_fn
