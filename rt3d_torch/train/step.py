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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

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

    def _transform(self, grads):
        """Zero the NaNs, then clip by the global norm, in place."""
        if self.zero_nans:
            for g in grads:
                g.masked_fill_(torch.isnan(g), 0.0)
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.clip_norm))

    def step(self, opt: torch.optim.AdamW, params: Dict[str, torch.Tensor],
             grads, state: dict) -> None:
        """One update of `params` and of `state` (in place) by `grads`,
        through `opt`, a `torch.optim.AdamW` over `params`."""
        self._transform(grads)
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

    The dp x fsdp mesh of the JAX package (`mesh`) needs several devices;
    one H100 has none, so a mesh raises (ROADMAP item 15)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step: the dp x fsdp mesh is not ported (ROADMAP item 15); "
            "one device trains without a mesh")
    optimizer = optimizer or AdamW(1e-4)
    params = dict(model.named_parameters())
    live = {"opt": None}
    engine = optimizer.make(params)

    def init_fn(seed: int = 0) -> TrainState:
        init_random(model, seed)
        live["opt"] = optimizer.init(params)
        return TrainState(params=params, opt_state=live["opt"],
                          step=torch.zeros((), dtype=torch.int64))

    def adopt(state: TrainState) -> None:
        """Copy a state whose tensors are not the live ones into them."""
        with torch.no_grad():
            for k, p in params.items():
                if state.params[k] is not p:
                    p.copy_(state.params[k])
            opt = live["opt"]
            if state.opt_state is not opt:
                opt["count"].copy_(state.opt_state["count"])
                for part in ("mu", "nu"):
                    for k, t in opt[part].items():
                        t.copy_(state.opt_state[part][k])

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        if live["opt"] is None:
            raise RuntimeError("make_train_step: call init_fn before step_fn")
        adopt(state)
        loss, parts = seg_detection_loss(model, batch["images"], batch)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(
            torch.autograd.grad(loss, list(params.values()), allow_unused=True),
            params.values())]
        with torch.no_grad():
            optimizer.step(engine, params, grads, live["opt"])
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        return TrainState(params=params, opt_state=live["opt"], step=state.step + 1), metrics

    return init_fn, step_fn

