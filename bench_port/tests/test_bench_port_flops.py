"""`bench_port.flops` against the port's model: at the cells' 384 x 640 it
is 2 x the multiply-accumulates of the same convolutions, counted with
hooks; at 640 x 640 it is printed beside Ultralytics' published GFLOPs."""

import pytest
import torch

from bench_port.flops import PUBLISHED_GFLOPS_640, yolo11_seg_flops


def _port_macs(variant, hw):
    from rt3d_torch.models.yolo import Conv, ConvTranspose2x, YoloSeg

    model = YoloSeg(variant=variant, input_hw=hw)
    macs = [0]

    def hook(mod, inp, out):
        w = mod.weight
        if isinstance(mod, Conv):
            macs[0] += out.shape[2] * out.shape[3] * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3]
        else:  # a 2 x 2 stride-2 transposed conv: one tap an output pixel and input channel
            macs[0] += out.shape[2] * out.shape[3] * w.shape[0] * w.shape[1]

    for mod in model.modules():
        if isinstance(mod, (Conv, ConvTranspose2x)):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, hw[0], hw[1], 3))
    return macs[0]


@pytest.mark.parametrize("variant", ["n", "x"])
def test_flops_equal_twice_the_port_models_macs(variant):
    assert yolo11_seg_flops(variant, (384, 640)) == 2 * _port_macs(variant, (384, 640))


@pytest.mark.parametrize("variant", ["n", "x"])
def test_flops_beside_the_published_count(variant):
    got = yolo11_seg_flops(variant, (640, 640)) / 1e9
    print(f"yolo11{variant}-seg at 640 x 640: {got:.2f} GFLOPs counted, "
          f"{PUBLISHED_GFLOPS_640[variant]} published (Ultralytics also counts the "
          "attention matmuls and elementwise ops)")
    assert got > 0
