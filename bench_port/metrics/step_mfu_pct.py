"""step layer (`rt3d_torch.pipeline.step`): the whole step's share of one
H100's dense bf16 peak (989 TFLOP/s, NVIDIA's data sheet, SXM, 700 W): the
FLOPs an image of the configuration's architecture (`flops_per_image` of
`arch/<name>.py`, from the published definition; for YOLO11-seg
`bench_port.flops`' layer table) times the cameras and the frames done in
the window, over the window's seconds."""

PEAK_BF16_FLOPS = 989e12


def read(record):
    if not record["frames"]:
        return None
    work = record["flops_per_image"] * record["cameras"] * len(record["frames"])
    return 100.0 * work / record["seconds"] / PEAK_BF16_FLOPS
