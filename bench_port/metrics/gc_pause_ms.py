"""step layer (`rt3d_torch.pipeline.step`): mean host ms a frame in Python's
garbage collections that fall inside the program's step (timed by the
program's `gc.callbacks` hook, `rt3d_torch.runtime.trace`), over the
window's frames (chosen as `host_syncs` chooses them)."""

from bench_port.metrics.host_syncs import window_steps


def read(record):
    steps = window_steps(record)
    if steps is None:
        return None
    return sum(b - a for rec in steps for _, a, b in rec["gc"]) / len(steps) / 1e6
