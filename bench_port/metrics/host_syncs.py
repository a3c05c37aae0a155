"""step layer (`rt3d_torch.pipeline.step`): mean host syncs a frame, every
site, over the window's frames: the program's own count
(`rt3d_torch.runtime.trace`), one for each place where the step's host
waits on the device (a read-back, a `nonzero`, a blocking copy).

The program's step records are taken by time, on the `perf_counter` clock
of the benchmark's host spans: the steps whose `step` span overlaps the
interval those spans cover (the window's frames, stepped one after another
on one thread). The readers of the program's spans share `window_steps`
and `span_ms`. Nothing is read from a program without the trace module, or
whose records do not cover every frame of the window."""


def window_steps(record):
    """The program's step records of the window's frames, or None."""
    try:
        from rt3d_torch.runtime import trace
    except ImportError:
        return None
    if not record["spans"] or not record["frames"]:
        return None
    lo = min(s[2] for s in record["spans"]) * 1e9
    hi = max(s[3] for s in record["spans"]) * 1e9
    steps = []
    for rec in trace.records():
        root = next((s for s in rec["spans"] if s.name == "step" and s.parent is None), None)
        if root is not None and root.end_ns and root.start_ns <= hi and root.end_ns >= lo:
            steps.append(rec)
    return steps if len(steps) == len(record["frames"]) else None


def span_ms(steps, match):
    """Mean host ms a step inside the spans whose name `match` accepts,
    each counted once: a span inside another accepted span is not
    added again."""
    total = 0
    for rec in steps:
        spans = rec["spans"]
        for s in spans:
            if not match(s.name):
                continue
            p = s.parent
            while p is not None and not match(spans[p].name):
                p = spans[p].parent
            if p is None:
                total += s.end_ns - s.start_ns
    return total / len(steps) / 1e6


def read(record):
    steps = window_steps(record)
    if steps is None:
        return None
    return sum(sum(rec["host_syncs"].values()) for rec in steps) / len(steps)
