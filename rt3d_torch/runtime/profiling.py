"""Device-level profiling: kernel times from a `torch.profiler` trace (port
of `rt3d/runtime/profiling.py`, which reads a `jax.profiler` trace).

`profile_op_times` runs a callable under the profiler with CUDA activity
and sums the device time of every kernel by name. It needs a CUDA device:
without one it raises rather than report host times under a device name.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def profile_op_times(fn: Callable[[], object], iters: int = 5
                     ) -> Tuple[float, Dict[str, float]]:
    """Run `fn` once outside the trace, then `iters` times under it.

    Returns (device ms per iteration, summed over every kernel;
    {kernel name: device ms per iteration}). The device is synchronized
    after the last call, inside the trace. A `record_function` range on
    the device timeline (a user annotation, such as
    ``Optimizer.step#AdamW.step``) spans kernels and is none: it counts in
    neither."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_op_times needs a CUDA device")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_op = {e.key: e.self_device_time_total / 1e3 / iters
              for e in prof.key_averages()
              if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)}
    return sum(per_op.values()), per_op


def format_op_times(total_ms: float, per_op: Dict[str, float],
                    top: int = 20, min_ms: float = 0.05) -> str:
    rows = [f"device total: {total_ms:.2f} ms/iter", "top ops:"]
    for name, ms in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]:
        if ms < min_ms:
            break
        rows.append(f"  {ms:8.3f} ms  {name[:70]}")
    return "\n".join(rows)
