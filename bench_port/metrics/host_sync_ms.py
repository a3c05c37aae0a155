"""step layer (`rt3d_torch.pipeline.step`): mean host ms a frame inside the
program's `sync.<site>` spans (`rt3d_torch.runtime.trace`), the host's
waits on the device, over the window's frames (chosen as `host_syncs`
chooses them)."""

from bench_port.metrics.host_syncs import span_ms, window_steps


def read(record):
    steps = window_steps(record)
    if steps is None:
        return None
    return span_ms(steps, lambda name: name.startswith("sync."))
