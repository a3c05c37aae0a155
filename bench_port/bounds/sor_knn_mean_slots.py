"""K3, the k-nearest mean distance within each fused object's slot
(`csrc/sor_knn.cu`)."""

from bench_port import roofline

MODULE = "rt3d_torch.geometry.sor"
FUNCTION = "sor_knn_mean_slots"
KERNELS = ("sor_knn_kernel", "sor_knn_large_kernel")


def bound(args, kwargs):
    return roofline.k3_bound(args[0], args[1])
