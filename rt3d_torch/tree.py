"""Trees of tensors: dataclasses, tuples, lists and dicts over tensors, with
None as an empty subtree (`FrameOutputs`, `PipelineState`, `Detections`, a
model's state dict). A leaf's path joins the field names, indices and keys
from the root with ``/`` (``trackers/0/mean``); the checkpoints of
`rt3d_torch.runtime.checkpoint` are keyed by these paths, so they are a
file format.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch


@functools.cache
def _field_names(cls: type) -> Tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(cls))


def _children(t: Any) -> List[Tuple[Any, Any]]:
    if dataclasses.is_dataclass(t):
        return [(n, getattr(t, n)) for n in _field_names(type(t))]
    if isinstance(t, (tuple, list)):
        return list(enumerate(t))
    if isinstance(t, Mapping):
        return list(t.items())
    raise TypeError(f"tree: unsupported node of type {type(t).__name__}")


def leaves_with_paths(t: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(t, torch.Tensor):
        yield prefix, t
    elif t is not None:
        for k, v in _children(t):
            yield from leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))


def leaves(t: Any, out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """The tensors of `t`, in order: `leaves_with_paths` without building
    the paths, which the step does not need."""
    out = [] if out is None else out
    if isinstance(t, torch.Tensor):
        out.append(t)
    elif t is not None:
        for _, v in _children(t):
            leaves(v, out)
    return out


def unflatten(like: Any, new: Sequence[torch.Tensor]) -> Any:
    """`like`'s structure over `new`, in `leaves(like)`'s order."""
    it = iter(new)

    def build(t):
        if t is None or isinstance(t, torch.Tensor):
            return t if t is None else next(it)
        kids = {k: build(v) for k, v in _children(t)}
        if dataclasses.is_dataclass(t):
            return type(t)(**kids)
        return type(t)(kids.values()) if isinstance(t, (tuple, list)) else kids

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree: more leaves than the structure holds")
    return out


def map(fn: Callable, *trees: Any) -> Any:
    """`fn` over the leaves of equal-structured trees, leaf by leaf."""
    return unflatten(trees[0], [fn(*xs) for xs in zip(*(leaves(t) for t in trees),
                                                         strict=True)])


def stack(trees: Sequence[Any]) -> Any:
    """Trees stacked on a new leading axis."""
    return map(lambda *xs: torch.stack(xs), *trees)


def index(t: Any, i) -> Any:
    """Entry `i` (an int or a slice) of every leaf's leading axis."""
    return map(lambda x: x[i], t)
