"""Checkpoint and resume of the pipeline's cross-frame state and its model
(port of `rt3d/runtime/checkpoint.py`).

Every piece of cross-frame state is an explicit tree of tensors: the
`PipelineState` (each camera's tracker with its Kalman means and
covariances, IDs and counters, the GMC grey images, the voxel accumulator)
and the model's state dict (a quantized model's int8 weights and f32
scales included). `save_pytree` writes such a tree of dataclasses, tuples,
lists and dicts to one ``.npz``, a leaf per path; `load_pytree` restores it
into the structure, dtypes and devices of `like`, refusing a missing leaf
or a shape that differs. numpy has no bfloat16, so those tensors are kept
as their int16 bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from rt3d_torch.tree import leaves_with_paths, unflatten


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def save_pytree(path: str, tree: Any) -> None:
    np.savez_compressed(path, **{k: _to_numpy(v) for k, v in leaves_with_paths(tree)})


def load_pytree(path: str, like: Any) -> Any:
    """Restore the checkpoint at `path` into the structure of `like`, each
    tensor in the dtype and on the device of `like`'s (shapes must match)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}

    def load(key: str, like_t: torch.Tensor) -> torch.Tensor:
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        if tuple(arr.shape) != tuple(like_t.shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(like_t.shape)}")
        t = torch.from_numpy(arr)
        if like_t.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device=like_t.device, dtype=like_t.dtype)

    return unflatten(like, [load(k, t) for k, t in leaves_with_paths(like)])
