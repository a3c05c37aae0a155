"""models and tracking layer (`rt3d_torch.models.sam`): SAM's image encoder
against its roofline over the window's frames. The device time is the
program's own: the `sam.encoder` device span (`rt3d_torch.runtime.trace`,
a pair of CUDA events on the step's stream around the encoder, resolved
after the run), read from the program's step records as the other
`program_span` readers read its host spans. The bound is the larger of
the encoder's FLOPs at one H100's dense bf16 peak (989 TFLOP/s) and its
bytes at 3.35 TB/s (NVIDIA's data sheet, SXM, 700 W): `sam_encoder_images`
(the program's count) times the FLOPs and activation bytes of an image,
and the weights once a span, each from `arch/sam_vit_h.py` at the
published ViT-H sizes. The record names no configuration, so the cell's own
count of FLOPs an image (`flops_per_image`) has to hold one ViT-H encoder
and less than a fifth more (YOLO's forward and the decoder's prompts);
a cell of other SAM sizes raises. Nothing where the program records no
such span."""

from bench_port import spec
from bench_port.metrics.host_syncs import window_steps

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def read(record):
    steps = window_steps(record)
    if steps is None:
        return None
    spans = [ms for r in steps for ms in r.get("device_ms", {}).get("sam.encoder", [])]
    images = sum(r["counts"].get("sam_encoder_images", 0) for r in steps)
    if not spans or not images or sum(spans) <= 0:
        return None
    arch = spec.architecture("sam_vit_h")
    s = arch.VIT_H
    enc = arch.encoder_flops(s)
    if not enc <= record["flops_per_image"] < 1.2 * enc:
        raise ValueError(f"the cell's {record['flops_per_image']} FLOPs an image hold no "
                         f"ViT-H encoder of {enc} alone; bound it with the cell's SAM sizes")
    flops_ms = images * arch.encoder_flops(s) / PEAK_BF16_FLOPS * 1e3
    bytes_ms = (len(spans) * arch.encoder_weight_bytes(s)
                + images * arch.encoder_activation_bytes(s)) / PEAK_BYTES_PER_S * 1e3
    return 100.0 * max(flops_ms, bytes_ms) / sum(spans)
