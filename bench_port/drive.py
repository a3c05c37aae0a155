"""The timed path: the program's `PipelineDriver` in fused mode, one frame
a dispatch, fed by an in-memory replay of the rendered frames, called in
chunks of a fixed number of frames until the window closes. The driver's
state carries over from chunk to chunk.

The source stamps each frame when the driver's uploader asks for it (its
capture time); `on_frame` stamps it when its outputs are done on the host.
Beside the stamps, `Recorder` keeps a reservoir sample, drawn from the
seed, of the frames done inside the window: each one's outputs and the
driver's state before and after it, for the comparison after the window.
The step never writes into the state it is given, so holding a reference
is enough."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bench_port.synthetic import ping_pong


@dataclass
class Packet:
    rgb: np.ndarray
    depth: np.ndarray
    status: np.ndarray


class ReplaySource:
    """Global frame g replays rendered frame `ping_pong(start + g, len(frames))`:
    every seed replays the same frames, from its own point of the cycle.
    `offset` is the global index of the chunk's first frame."""

    def __init__(self, frames: Sequence[Tuple[np.ndarray, np.ndarray]], start: int = 0):
        self.frames = frames
        self.start = start
        self.offset = 0
        self.capture: Dict[int, float] = {}
        self._ok = np.zeros(frames[0][0].shape[0], np.uint32)

    def get(self, idx: int) -> Packet:
        g = self.offset + idx
        self.capture[g] = time.perf_counter()
        return Packet(*self.frame(g), self._ok)

    def frame(self, g: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.frames[ping_pong(self.start + g, len(self.frames))]


@dataclass
class Kept:
    frame: int
    before: object   # the driver's state before the frame (None: the initial state)
    after: object    # the driver's state after it
    outputs: object


class Recorder:
    """`on_frame` for the driver: done stamps, and the reservoir of `keep`
    frames done before `close` (set when the window opens).

    Each kept frame holds references to the driver's state before and after
    it, and nothing is copied inside the window. That is sound only while
    the program's step builds every state anew and never writes into one it
    was given: the trackers and accumulator today, and a mask model's state
    (`PipelineState.mask_state`, a dataclass of tensors or a tuple of them;
    see `bench_port.check.ReferencePipeline`). It costs device memory: up to
    `keep` + 1 frames, each with two states. A memory bank of SAM 2's size
    (7 x 64 x 64 x 64 bf16, 3.7 MB an object) at 64 tracker slots on each
    of two cameras is 470 MB a state, so 8 sampled frames and frame 0 keep
    about 8.5 GB of banks, of the card's 80 GB."""

    def __init__(self, driver, source: ReplaySource, keep: int, seed: int):
        self.driver = driver
        self.source = source
        self.done: Dict[int, float] = {}
        self.keep = keep
        self.rng = np.random.default_rng(seed)
        self.kept: List[Kept] = []
        self.first: Optional[Kept] = None  # frame 0, from the initial state
        self.open: Optional[float] = None
        self.close: Optional[float] = None
        self.seen = 0
        self._before = None

    def __call__(self, j: int, out) -> None:
        t = time.perf_counter()
        g = self.source.offset + j
        self.done[g] = t
        before, after = self._before, self.driver.state
        self._before = after
        if g == 0:
            self.first = Kept(0, None, after, out)
        if self.open is not None and t <= self.close:
            self.seen += 1
            if len(self.kept) < self.keep:
                self.kept.append(Kept(g, before, after, out))
            else:
                r = int(self.rng.integers(self.seen))
                if r < self.keep:
                    self.kept[r] = Kept(g, before, after, out)


def run_frames(driver, source: ReplaySource, recorder: Recorder, start: int, count: int) -> None:
    source.offset = start
    driver.run(source, count, warmup=0, on_frame=recorder)


def run_window(driver, source: ReplaySource, recorder: Recorder, start: int,
               seconds: float, chunk: int) -> Tuple[float, float, int]:
    """Chunks of `chunk` frames from global frame `start` until `seconds`
    have passed. Returns (open, close, next global frame)."""
    recorder.open = time.perf_counter()
    recorder.close = recorder.open + seconds
    g = start
    while time.perf_counter() < recorder.close:
        run_frames(driver, source, recorder, g, chunk)
        g += chunk
    return recorder.open, recorder.close, g
