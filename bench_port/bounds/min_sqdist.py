"""K4, the least squared distance from each workspace point to the fused
objects' points (`csrc/min_d2.cu`)."""

from bench_port import roofline

MODULE = "rt3d_torch.geometry.subtract"
FUNCTION = "min_sqdist"
KERNELS = ("min_d2_kernel", "ref_boxes_kernel")


def bound(args, kwargs):
    return roofline.k4_bound(args[0], roofline.arg(args, kwargs, 4, "query_valid"), args[1],
                             args[2], roofline.arg(args, kwargs, 3, "threshold"))
