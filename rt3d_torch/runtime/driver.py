"""The host-side step driver: feed frames, run the step, log (port of
`rt3d/runtime/driver.py`).

Replaces the reference's `while key != ord('q')` loops
(`2cam/2cams_mask_gpu.py:176-455`). Two execution modes:

* `fused`: one `Pipeline.step` per frame pair; the host measures end-to-end
  latency only. With ``frames_per_dispatch`` K > 1 it runs K frames a call
  through `Pipeline.step_scan`.
* `profile`: the same step with a device synchronize closing each of the
  reference's stage groups, so every `timings.csv` row gets its own number.
  Slower than `fused` by construction; its outputs are fused mode's.

A frame with a non-zero per-camera status is skipped, as the reference
skips a frame whose capture failed (`2cam/2cams.py:174-176`).

On a CUDA pipeline, one uploader thread fetches frames `pipeline_depth`
ahead and copies them to the card through pinned memory on a stream of its
own, recording an event per frame; the compute stream waits on that event
before the step. The uploader is shut down and joined on every exit from
`run`, an exception in `on_frame` included.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from rt3d_torch.pipeline.step import FrameOutputs, Pipeline, index_outputs
from rt3d_torch.runtime.timing import TimingLog


@dataclass
class DriverResult:
    frames: int
    mean_fps: float
    median_fps: float
    max_fps: float
    summary_ms: Dict[str, float]
    last_outputs: Optional[FrameOutputs] = None
    skipped_frames: int = 0


class PipelineDriver:
    """Drives `pipeline` (its model already cast by `build_pipeline`) over a
    frame source, on the pipeline's device.

    ``pipeline_depth`` D > 1 keeps D frames in flight: the host waits for
    frame i-(D-1) while frame i runs, at D-1 frames of latency. The port's
    step reads back to the host inside itself (a flag per greedy-matching
    round, the fusion's loop over slots), so such overlap is small.
    ``frames_per_dispatch`` K > 1 runs K frames per `Pipeline.step_scan`
    call (recorded replays only; a live camera delivers one frame at a
    time)."""

    def __init__(
        self,
        pipeline: Pipeline,
        mode: str = "fused",
        fps_log_path: Optional[str] = None,
        timings_path: Optional[str] = None,
        pipeline_depth: int = 1,
        frames_per_dispatch: int = 1,
    ):
        if mode not in ("fused", "profile"):
            raise ValueError(f"unknown driver mode {mode}")
        self.pipeline_depth = max(1, pipeline_depth)
        self.frames_per_dispatch = max(1, frames_per_dispatch)
        if self.frames_per_dispatch > 1 and mode != "fused":
            raise ValueError("frames_per_dispatch requires mode='fused'")
        self.device = pipeline.device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the pipeline is on a CUDA device and none is available")
        self.pipeline = pipeline
        self.mode = mode
        self.calib = pipeline.calib()
        self.state = pipeline.init_state()
        self.log = TimingLog(fps_log_path, timings_path)
        self.skipped_frames = 0

    # -- device plumbing ------------------------------------------------

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _upload(self, arrays: Sequence[np.ndarray], stream):
        """Host arrays -> tensors on the pipeline's device, plus the event
        that marks their copies done (None off the card). On the card each
        array is staged in pinned memory and copied with ``non_blocking`` on
        `stream`; PyTorch's pinned-memory cache records the copy on its
        block, so the block is not refilled before the copy has finished."""
        if not self._cuda:
            return [torch.tensor(a) for a in arrays], None
        with torch.cuda.stream(stream):
            out = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                   .to(self.device, non_blocking=True) for a in arrays]
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def _adopt(self, tensors, ready) -> None:
        """Make the compute stream wait for an upload, and keep the caching
        allocator from reusing the uploaded blocks (allocated on the upload
        stream) before the compute stream is done with them."""
        if ready is None:
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(ready)
        for t in tensors:
            t.record_stream(compute)

    def _mark(self):
        """An event after the work issued so far on the compute stream."""
        if not self._cuda:
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done

    @staticmethod
    def _wait(done) -> None:
        if done is not None:
            done.synchronize()

    # -- one frame ------------------------------------------------------

    def _run_fused(self, rgb, depth) -> FrameOutputs:
        self.state, out = self.pipeline.step(self.state, rgb, depth, self.calib)
        return out

    def _run_profiled(self, rgb, depth) -> FrameOutputs:
        log = self.log

        @contextlib.contextmanager
        def span(name):
            with log.span(name):
                yield
                if self._cuda:
                    torch.cuda.synchronize(self.device)

        self.state, out = self.pipeline.step(self.state, rgb, depth, self.calib, stage=span)
        return out

    # ------------------------------------------------------------------

    def run(
        self,
        source,
        num_frames: int,
        warmup: int = 1,
        on_frame: Optional[Callable[[int, FrameOutputs], None]] = None,
        fetch_outputs: bool = True,
    ) -> DriverResult:
        """Step `num_frames` frames of `source`; `on_frame(i, outputs)` sees
        each good frame in order once its outputs are done. FPS counts the
        frames from index `warmup` on."""
        stream = torch.cuda.Stream(self.device) if self._cuda else None
        uploader = ThreadPoolExecutor(max_workers=1, thread_name_prefix="rt3d-upload")
        try:
            if self.frames_per_dispatch > 1:
                return self._run_scan_loop(uploader, stream, source, num_frames, warmup,
                                           on_frame, fetch_outputs)
            return self._run_frame_loop(uploader, stream, source, num_frames, warmup,
                                        on_frame, fetch_outputs)
        finally:
            uploader.shutdown(wait=True, cancel_futures=True)

    def _run_frame_loop(self, uploader, stream, source, num_frames, warmup, on_frame,
                        fetch_outputs) -> DriverResult:
        def fetch(idx):
            pkt = source.get(idx)
            if np.asarray(pkt.status).any():
                return None, True
            return self._upload((pkt.rgb, pkt.depth), stream), False

        in_flight = deque(uploader.submit(fetch, j)
                          for j in range(min(self.pipeline_depth, num_frames)))
        next_fetch = len(in_flight)

        fps_hist = []
        out = None
        last_done = None
        skipped = 0
        pending = deque()
        t_measure = None  # wall-clock start of the post-warmup window
        for i in range(num_frames):
            t0 = time.perf_counter()
            with self.log.span("Frame Retrieval"):
                upload, bad = in_flight.popleft().result()
                if next_fetch < num_frames:
                    in_flight.append(uploader.submit(fetch, next_fetch))
                    next_fetch += 1
            # no "Depth Retrieval" span: depth arrives with the RGB packet,
            # so the row is absent rather than a misleading zero
            if bad:
                skipped += 1
                continue
            (rgb, depth), ready = upload
            self._adopt((rgb, depth), ready)

            if self.mode == "fused":
                out = self._run_fused(rgb, depth)
                last_done = self._mark()
                if fetch_outputs:
                    pending.append((i, out, last_done))
                    if len(pending) >= self.pipeline_depth:
                        # coalesced sync: the step's work runs in order on
                        # the compute stream, so the newest event done means
                        # every pending frame is done
                        self._wait(pending[-1][2])
                        while pending:
                            j, out_j, _ = pending.popleft()
                            if on_frame is not None:
                                on_frame(j, out_j)
            else:
                out = self._run_profiled(rgb, depth)
                if on_frame is not None:
                    on_frame(i, out)

            total = time.perf_counter() - t0
            self.log.end_iteration(total)
            if i >= warmup:
                if t_measure is None:
                    t_measure = t0
                fps_hist.append(1.0 / max(total, 1e-9))
        # drain INSIDE the measured window: in-flight frames are not done,
        # and deep pipelining must not get credit for them
        self._wait(last_done)
        for j, out_j, _ in pending:
            if on_frame is not None:
                on_frame(j, out_j)
        elapsed = time.perf_counter() - t_measure if t_measure is not None else 0.0
        self.skipped_frames = skipped
        self.log.write_timings()
        # mean_fps is wall-clock throughput (frames / elapsed): a mean of
        # per-frame 1/dt would overweight the cheap dispatch-only iterations
        # that pipelined execution produces in bursts
        measured = len(fps_hist)
        fps_arr = np.asarray(fps_hist) if fps_hist else np.asarray([0.0])
        return DriverResult(
            frames=num_frames,
            mean_fps=float(measured / elapsed) if elapsed > 0 else 0.0,
            median_fps=float(np.median(fps_arr)),
            max_fps=float(fps_arr.max()),
            summary_ms=self.log.summary_ms(),
            last_outputs=out,
            skipped_frames=skipped,
        )

    def _run_scan_loop(self, uploader, stream, source, num_frames, warmup, on_frame,
                       fetch_outputs) -> DriverResult:
        """K frames per `Pipeline.step_scan` call, chunks `pipeline_depth`
        deep. A chunk runs every frame it holds (a bad one computes and
        leaves the state as it was); one with no good frame is not run."""
        k = self.frames_per_dispatch

        def fetch_chunk(start):
            pkts = [source.get(j) for j in range(start, min(start + k, num_frames))]
            good = np.asarray([not np.asarray(p.status).any() for p in pkts], bool)
            if not good.any():
                return None, good
            arrays = (np.stack([p.rgb for p in pkts]), np.stack([p.depth for p in pkts]))
            return self._upload(arrays, stream), good

        starts = list(range(0, num_frames, k))
        in_flight = deque(uploader.submit(fetch_chunk, s)
                          for s in starts[:self.pipeline_depth])
        next_chunk = len(in_flight)

        last_good = None  # (outputs with a frame axis, frame) of the last good frame
        skipped = 0
        pending = deque()
        t_measure = None
        measured = 0
        per_frame_times: list = []
        last_done = None

        def drain_one():
            s0, out_k, good, done = pending.popleft()
            self._wait(done)
            if on_frame is not None:
                for j in np.flatnonzero(good):
                    on_frame(s0 + int(j), index_outputs(out_k, int(j)))

        for s in starts:
            t0 = time.perf_counter()
            upload, good = in_flight.popleft().result()
            if next_chunk < len(starts):
                in_flight.append(uploader.submit(fetch_chunk, starts[next_chunk]))
                next_chunk += 1
            t_retr = time.perf_counter() - t0
            n_real, ngood = len(good), int(good.sum())
            skipped += n_real - ngood
            if ngood == 0:
                continue  # every state update would be dropped, no output read
            (rgb, depth), ready = upload
            self._adopt((rgb, depth), ready)
            self.state, out_k = self.pipeline.step_scan(self.state, rgb, depth,
                                                        self.calib, good)
            last_done = self._mark()
            last_good = (out_k, int(np.flatnonzero(good)[-1]))
            if fetch_outputs:
                pending.append((s, out_k, good, last_done))
                if len(pending) >= self.pipeline_depth:
                    drain_one()
            total = time.perf_counter() - t0
            # one CSV row per GOOD frame, so columns stay frame-aligned with
            # the frame loop; the chunk's cost is split over the n_real
            # frames it ran, bad ones included (their share goes unlogged)
            for _ in range(ngood):
                self.log.add("Frame Retrieval", t_retr / n_real)
                self.log.end_iteration(total / n_real)
            if s >= warmup:
                if t_measure is None:
                    t_measure = t0
                measured += ngood
                per_frame_times.extend([total / n_real] * ngood)
        while pending:
            drain_one()
        self._wait(last_done)
        elapsed = time.perf_counter() - t_measure if t_measure is not None else 0.0
        self.skipped_frames = skipped
        self.log.write_timings()
        per_frame = np.asarray(per_frame_times)
        return DriverResult(
            frames=num_frames,
            mean_fps=float(measured / elapsed) if elapsed > 0 else 0.0,
            median_fps=float(1.0 / np.median(per_frame)) if len(per_frame) else 0.0,
            max_fps=float(1.0 / per_frame.min()) if len(per_frame) else 0.0,
            summary_ms=self.log.summary_ms(),
            last_outputs=index_outputs(*last_good) if last_good is not None else None,
            skipped_frames=skipped,
        )
