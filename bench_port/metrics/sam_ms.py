"""models and tracking layer (`rt3d_torch.models.sam`): mean host ms a
frame in the program's `sam.*` spans (`sam.preprocess` and `sam.encoder`
under `YOLO11 Inference`, `sam.decoder` and `sam.postprocess` under `Mask
Processing`), over the window's frames (chosen as `host_syncs` chooses
them). Nothing from a program that runs no SAM."""

from bench_port.metrics.host_syncs import span_ms, window_steps


def read(record):
    steps = window_steps(record)
    if steps is None or not any(s.name.startswith("sam.") for r in steps for s in r["spans"]):
        return None
    return span_ms(steps, lambda name: name.startswith("sam."))
