"""K1, the window dedupe of the object and workspace voxel keys
(`csrc/window.cu`)."""

from bench_port import roofline

MODULE = "rt3d_torch.geometry.ops"
FUNCTION = "window_dedupe"
KERNELS = ("window_kernel", "window_wide_kernel")


def bound(args, kwargs):
    return roofline.k1_bound(args[0], roofline.arg(args, kwargs, 1, "dy_max", 4),
                             roofline.arg(args, kwargs, 2, "dx_max", 6))
