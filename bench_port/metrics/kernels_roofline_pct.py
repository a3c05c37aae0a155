"""kernels layer (`rt3d_torch.kernels`, K1-K5 of `rt3d_torch/csrc`): the
sum of the bounds (`bench_port.roofline`) of the kernel launches in the
profiled frames over the sum of those kernels' device time in the
profiler's trace, kernels matched by name. Nothing when no kernel ran."""


def read(record):
    t = record["trace"]
    if not t or not t["launches"] or t["kernel_ms"] <= 0:
        return None
    return 100.0 * t["bound_ms"] / t["kernel_ms"]
