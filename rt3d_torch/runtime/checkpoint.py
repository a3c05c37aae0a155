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

import dataclasses
from typing import Any, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    def sub(name) -> str:
        return f"{prefix}/{name}" if prefix else str(name)

    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), sub(f.name))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, sub(i))
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, sub(k))
    else:
        raise TypeError(f"checkpoint: unsupported leaf {prefix!r} of type {type(tree).__name__}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def save_pytree(path: str, tree: Any) -> None:
    np.savez_compressed(path, **{k: _to_numpy(v) for k, v in _leaves(tree)})


def load_pytree(path: str, like: Any) -> Any:
    """Restore the checkpoint at `path` into the structure of `like`, each
    tensor in the dtype and on the device of `like`'s (shapes must match)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}

    def build(tree: Any, prefix: str) -> Any:
        def sub(name) -> str:
            return f"{prefix}/{name}" if prefix else str(name)

        if isinstance(tree, torch.Tensor):
            if prefix not in data:
                raise KeyError(f"checkpoint missing leaf {prefix}")
            arr = data[prefix]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"{prefix}: shape {arr.shape} != {tuple(tree.shape)}")
            t = torch.from_numpy(arr)
            if tree.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            return t.to(device=tree.device, dtype=tree.dtype)
        if dataclasses.is_dataclass(tree):
            return type(tree)(**{f.name: build(getattr(tree, f.name), sub(f.name))
                                 for f in dataclasses.fields(tree)})
        if isinstance(tree, (tuple, list)):
            return type(tree)(build(v, sub(i)) for i, v in enumerate(tree))
        if isinstance(tree, Mapping):
            return {k: build(v, sub(k)) for k, v in tree.items()}
        raise TypeError(f"checkpoint: unsupported leaf {prefix!r} of type {type(tree).__name__}")

    return build(like, "")
