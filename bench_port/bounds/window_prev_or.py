"""K2, the OR of earlier mask words of equal keys in a window
(`csrc/window.cu`)."""

from bench_port import roofline

MODULE = "rt3d_torch.geometry.ops"
FUNCTION = "window_prev_or"
KERNELS = ("window_kernel", "window_wide_kernel")


def bound(args, kwargs):
    return roofline.k2_bound(args[0], args[1], roofline.arg(args, kwargs, 2, "dy_max", 4),
                             roofline.arg(args, kwargs, 3, "dx_max", 6))
