"""models and tracking layer (`rt3d_torch.models`): mean host ms a frame in
the program's `preprocess` and `detect.*` spans (`rt3d_torch.runtime.trace`:
the letterbox, the YOLO forward, decode with NMS and centre dedupe, the
ReID embeddings), over the window's frames (chosen as `host_syncs` chooses
them)."""

from bench_port.metrics.host_syncs import span_ms, window_steps


def read(record):
    steps = window_steps(record)
    if steps is None:
        return None
    return span_ms(steps, lambda name: name == "preprocess" or name.startswith("detect."))
