"""K5, the k-nearest mean distance over one cloud (`csrc/sor_knn.cu`)."""

from bench_port import roofline

MODULE = "rt3d_torch.geometry.sor"
FUNCTION = "sor_knn_mean"
KERNELS = ("sor_knn_kernel", "sor_knn_large_kernel")


def bound(args, kwargs):
    return roofline.k5_bound(args[0], args[1])
