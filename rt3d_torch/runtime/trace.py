"""Spans and counters inside the port's step, on the profiler's clock.

Everything stays in memory, one record a traced step, in a ring of the last
`RING_STEPS` steps; `records()` hands them out. A record holds:

* spans: name, the step's index, the parent span (its index in the step's
  spans, None at a root), the thread, and start and end from
  `time.perf_counter_ns()`, the clock of `time.perf_counter`. `Pipeline.step`
  opens the root `step`; the five `timings.csv` groups are spans under it,
  and the stages below them spans under those;
* host syncs by site: every place where the step's host waits on the
  device goes through `sync(site)`, which opens the span `sync.<site>`
  that times the wait; `records()` counts them by site;
* garbage collections inside the step: generation, start and end, from a
  `gc.callbacks` hook that is installed only while tracing is on;
* the step's kernel launches, the deltas of `kernels.LAUNCHES`;
* the step's counts of the events in `COUNTS`, each from `count(name, n)`:
  the replays and the captures of `Pipeline.detect`'s CUDA graph, the
  images SAM's encoder ran on and the box prompts its decoder ran on, and
  the replays and the captures of `Pipeline.track`'s CUDA graph;
* device spans: a site opened with `device_span` on a CUDA device also
  records a pair of CUDA events on the current stream; `records()` gives
  their elapsed device ms, read once the caller has finished the run, so
  the step itself never waits for them.

Tracing is on for a step that `Pipeline.step` is handed a `stage` hook for
(the driver's profile mode, a benchmark's traced run), and for every step
once `enable()` is called. It stays on between two traced steps, so that the
driver's uploader thread, which copies the next frame while a step runs,
records its `upload` spans; the first untraced step switches it off. Off,
each site costs one test of `ON` and returns a shared no-op context: no
span object, no `record_function`, no allocation.

While a `torch.profiler` records, each span is also a `record_function`
range under its own name, so the profiler's trace shows the program's spans
beside the kernels, on the profiler's clock.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

from rt3d_torch import kernels

# steps the ring keeps: 51 s at 80 frames a second
RING_STEPS = 4096
# what `count` counts, each in every record
COUNTS = ("detect_graph_replays", "detect_graph_captures", "sam_encoder_images",
          "sam_prompt_slots", "track_graph_replays", "track_graph_captures")

ON = False       # tracing on now: the one flag every site tests
_enabled = False  # `enable()` was called
_ring: collections.deque = collections.deque(maxlen=RING_STEPS)
_open: Optional["_Record"] = None  # the record of the step running now
_step_thread: Optional[int] = None  # the thread that ran the last step
_next_step = 0
_gc_start = 0
_local = threading.local()
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    step: int
    parent: Optional[int]  # index of the enclosing span in the step's spans
    thread: str
    start_ns: int
    end_ns: int


class _Record:
    __slots__ = ("step", "spans", "gc", "device", "launches", "counts", "_launches0")

    def __init__(self, step: int):
        self.step = step
        self.spans: List[list] = []  # [name, parent, thread, start_ns, end_ns]
        self.gc: List[tuple] = []    # (generation, start_ns, end_ns)
        self.device: List[tuple] = []  # (name, start event, end event)
        self.launches: Dict[str, int] = {}
        self.counts: Dict[str, int] = dict.fromkeys(COUNTS, 0)
        self._launches0 = dict(kernels.LAUNCHES)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "rec", "entry", "rf")

    def __init__(self, name: str, rec: Optional[_Record] = None):
        self.name, self.rec = name, rec

    def __enter__(self):
        rec = self.rec
        if rec is None:
            rec = _open
            # between two steps only another thread's span (the uploader's)
            # is kept, in the last step's record: a stage called on its own
            # is no step's
            if rec is None and _ring and threading.get_ident() != _step_thread:
                rec = _ring[-1]
            self.rec = rec
        if rec is None:
            return self
        stack = _stack()
        parent = stack[-1][1] if stack and stack[-1][0] is rec else None
        # the range opens before the stamp and closes after it: the span
        # lies inside its range, one constant offset from it
        self.rf = None
        if _profiler._is_profiler_enabled:  # PyTorch's own cheap test of a recording profiler
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.entry = [self.name, parent, threading.current_thread().name,
                      time.perf_counter_ns(), 0]
        stack.append((rec, len(rec.spans)))
        rec.spans.append(self.entry)
        return self

    def __exit__(self, *exc):
        if self.rec is None:
            return False
        self.entry[4] = time.perf_counter_ns()
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _DeviceSpan(_Span):
    """A span that also records a CUDA event on the current stream of
    `device` as it opens and as it closes."""

    __slots__ = ("device", "events")

    def __init__(self, name: str, device):
        super().__init__(name)
        self.device = device

    def __enter__(self):
        super().__enter__()
        if self.rec is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
            self.rec.device.append((self.name, *self.events))
        return super().__exit__(*exc)


class _Step:
    __slots__ = ("rec", "root")

    def __enter__(self):
        global _open, _next_step, _step_thread
        if not ON:
            _switch(True)
        _step_thread = threading.get_ident()
        # the root is the record's first span, before the uploader can see it
        self.rec = _Record(_next_step)
        _next_step += 1
        self.root = _Span("step", rec=self.rec)
        self.root.__enter__()
        _open = self.rec
        _ring.append(self.rec)
        return self

    def __exit__(self, *exc):
        global _open
        self.root.__exit__(*exc)
        rec = self.rec
        rec.launches = {k: v - rec._launches0.get(k, 0) for k, v in kernels.LAUNCHES.items()
                        if v != rec._launches0.get(k, 0)}
        _open = None
        return False


def _gc_callback(phase: str, info: dict) -> None:
    global _gc_start
    if _open is None:
        return
    if phase == "start":
        _gc_start = time.perf_counter_ns()
    else:
        _open.gc.append((info["generation"], _gc_start, time.perf_counter_ns()))


def _switch(on: bool) -> None:
    global ON
    ON = on
    if on and _gc_callback not in gc.callbacks:
        gc.callbacks.append(_gc_callback)
    elif not on and _gc_callback in gc.callbacks:
        gc.callbacks.remove(_gc_callback)


# -- the sites ----------------------------------------------------------------


def step(hooked: bool):
    """The context of one `Pipeline.step`: with tracing on for it (`hooked`:
    the caller handed the step a `stage` hook; or `enable()` was called),
    a new record in the ring and its root span `step`."""
    if not (hooked or _enabled):
        if ON:
            _switch(False)
        return _NULL
    return _Step()


def span(name: str):
    """A span `name` under the innermost span open on this thread."""
    if not ON:
        return _NULL
    return _Span(name)


def sync(site: str):
    """Around one place where the host waits on the device (a read-back,
    a `nonzero`, boolean-mask indexing, a blocking copy): the span
    `sync.<site>`, which times the wait and counts it under `site`."""
    if not ON:
        return _NULL
    return _Span("sync." + site)


def device_span(name: str, device):
    """A span `name` as `span` gives, which on a CUDA `device` also times
    the device work queued inside it on the current stream, by a pair of
    CUDA events; on any other device a plain span."""
    if not ON:
        return _NULL
    if getattr(device, "type", None) != "cuda":
        return _Span(name)
    return _DeviceSpan(name, device)


def count(name: str, n: int = 1) -> None:
    """`n` more `name` (one of `COUNTS`) in the record of the step
    running now; nothing outside a traced step. `n` is known on the host."""
    if ON and _open is not None:
        _open.counts[name] += n


# -- the operator's use -------------------------------------------------------


def enable() -> None:
    """Trace every step from now on."""
    global _enabled
    _enabled = True
    _switch(True)


def disable() -> None:
    """Trace only the steps handed a `stage` hook again; off until the next."""
    global _enabled
    _enabled = False
    _switch(False)


def clear() -> None:
    """Forget every record."""
    _ring.clear()


def records() -> List[Dict]:
    """The ring's step records, oldest first, each a dict: `step` (the
    traced step's index), `spans` ([`Span`], in the order they opened),
    `host_syncs` ({site: count} of the `sync.<site>` spans), `gc`
    ([(generation, start_ns, end_ns)]), `launches` ({kernel counter:
    launches in the step}), `counts` ({name: count} of every name in
    `COUNTS`) and `device_ms` ({name: [device ms of each device span]}).
    Spans still open have `end_ns` 0. A device span's events are waited
    for here, so call this once the traced steps are done."""
    out = []
    for rec in list(_ring):
        spans = [Span(n, rec.step, p, t, a, b) for n, p, t, a, b in list(rec.spans)]
        syncs = collections.Counter(s.name[5:] for s in spans if s.name.startswith("sync."))
        device: Dict[str, List[float]] = {}
        for name, start, end in list(rec.device):
            end.synchronize()
            device.setdefault(name, []).append(start.elapsed_time(end))
        out.append(dict(step=rec.step, spans=spans, host_syncs=dict(syncs), gc=list(rec.gc),
                        launches=dict(rec.launches), counts=dict(rec.counts),
                        device_ms=device))
    return out
