"""CUDA-graph capture and replay of the step's stages: a stage replays
`fn(*args)`, `args` a tree of tensors (`rt3d_torch.tree`), where
`replayable` and its own condition hold; `replayed` recaptures when the
stage's key changes."""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from rt3d_torch import tree
from rt3d_torch.runtime import trace


def replayable(device: torch.device) -> bool:
    """On the card, with autograd off."""
    return device.type == "cuda" and not torch.is_grad_enabled()


def copy_all(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """``d.copy_(s)`` for every pair, as one foreach copy a dtype."""
    groups = {}
    for d, s in zip(dst, src):
        ds, ss = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def copied(out: Any) -> Any:
    """A new tree equal to `out`, by `copy_all`: what a caller keeps of a
    graph's outputs outlives the next replay."""
    held = tree.leaves(out)
    new = [torch.empty_like(t) for t in held]
    copy_all(new, held)
    return tree.unflatten(out, new)


class CapturedGraph:
    """`fn(*args)` captured once in a CUDA graph, for one `key`: what the
    caller can observe that the capture depends on. `args` is rebuilt over
    static buffers of its leaves; `replay` copies new leaves into them and
    replays the graph on the current stream. What `replay` returns, `fn`'s
    outputs, lives in the graph's memory and the next replay overwrites
    it. The graph keeps neither `fn` nor what `fn` is bound to."""

    def __init__(self, fn: Callable, args: tuple, key: tuple):
        self.key = key
        self.args = tree.map(torch.empty_like, args)
        self._buffers = tree.leaves(self.args)
        copy_all(self._buffers, tree.leaves(args))
        # the side stream starts behind the current one, which waits on
        # the uploader's event; the warm-up on it makes the library
        # handles, workspaces and cuDNN plans the capture then reuses
        dev = self._buffers[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*self.args)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the driver's uploader thread goes on copying frames
        # on its own stream while this thread captures
        with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
            self.outputs = fn(*self.args)

    def replay(self, args: tuple):
        copy_all(self._buffers, tree.leaves(args))
        self.graph.replay()
        return self.outputs


def replayed(owner: Any, stage: str, key: tuple, fn: Callable, *args):
    """`fn(*args)` from the CUDA graph `owner` keeps for `stage` (in
    ``owner._<stage>_graph``): captured anew, under the sync
    ``step.<stage>_capture``, when there is none or its key is not `key`,
    then replayed on `args`. Counts ``<stage>_graph_captures`` and
    ``<stage>_graph_replays``; returns the graph's outputs."""
    attr = f"_{stage}_graph"
    graph = getattr(owner, attr)
    if graph is None or graph.key != key:
        graph = None
        setattr(owner, attr, None)  # its memory goes back before the capture
        # the capture synchronizes the device
        with trace.sync(f"step.{stage}_capture"):
            graph = CapturedGraph(fn, args, key)
        setattr(owner, attr, graph)
        trace.count(f"{stage}_graph_captures")
    out = graph.replay(args)
    trace.count(f"{stage}_graph_replays")
    return out
