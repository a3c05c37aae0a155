"""geometry layer (`rt3d_torch.geometry`): mean host ms a frame inside the
step's mask, point-cloud, fusion and subtraction stages (masks, object and
workspace clouds, fusion, subtraction, accumulation), over the window's
frames."""

from bench_port.stats import stage_ms


def read(record):
    return stage_ms(record["spans"], record["frames"],
                    ("Mask Processing", "Point Cloud Processing", "Point Cloud Fusion",
                     "Subtraction"))
