"""models and tracking layer (`rt3d_torch.tracking`): mean host ms a frame in
the program's `track.*` spans (`rt3d_torch.runtime.trace`: GMC, each
camera's tracker step), over the window's frames (chosen as `host_syncs`
chooses them)."""

from bench_port.metrics.host_syncs import span_ms, window_steps


def read(record):
    steps = window_steps(record)
    if steps is None:
        return None
    return span_ms(steps, lambda name: name.startswith("track."))
