"""Launch bookkeeping shared by the CUDA kernel wrappers.

Each wrapper (in the module that owns its plain PyTorch version)
checks its tensors, allocates its outputs and calls `launch`, which adds one
to the wrapper's entry of `LAUNCHES` (and, for K3 and K5 at k above their
register path's 32, to its ``_large_k`` entry too: the launch went to the
radix-select kernel). A CPU tensor, or an explicit ``plain=True``, takes the
plain version and launches nothing.
"""

from __future__ import annotations

import torch

# one launch counter per kernel wrapper; see `launch`
LAUNCHES: dict[str, int] = {
    "window_dedupe": 0,    # K1
    "window_prev_or": 0,   # K2
    "sor_knn_slots": 0,    # K3
    "min_sqdist": 0,       # K4
    "sor_knn": 0,          # K5
    "sor_knn_slots_large_k": 0,  # K3 launches at k > 32 (radix select)
    "sor_knn_large_k": 0,        # K5 launches at k > 32 (radix select)
    "greedy_match": 0,           # the trackers' greedy matching (no TPU kernel)
    "sam_attention": 0,          # SAM's encoder attention, one a block (no TPU kernel)
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def use_kernel(t: torch.Tensor, plain: bool) -> bool:
    """True when `t` must go through the CUDA kernel: it lies on a CUDA
    device and the caller did not ask for the plain version."""
    if plain or t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return True


def check(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    (-1 matches any extent)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s != -1 and s != g for s, g in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(name, entry: str, *args) -> None:
    """Call C entry `entry` of the kernel library on the current stream and
    count the launch under `name` (a counter, or a tuple of counters).
    Raises if the launch was refused."""
    from rt3d_torch.kernels.build import load_library

    fn = getattr(load_library(), entry)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} at launch")
    for n in (name,) if isinstance(name, str) else name:
        LAUNCHES[n] += 1
