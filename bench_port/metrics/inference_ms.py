"""models and tracking layer (`rt3d_torch.models`, `rt3d_torch.tracking`):
mean host ms a frame inside the step's `YOLO11 Inference` stage
(preprocess, the YOLO forward, decode and NMS, the trackers), over the
window's frames."""

from bench_port.stats import stage_ms


def read(record):
    return stage_ms(record["spans"], record["frames"], ("YOLO11 Inference",))
