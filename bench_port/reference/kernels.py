"""The reference runs the plain PyTorch version of every kernel: no call
takes a kernel path, so nothing is built or launched."""

LAUNCHES: dict = {}


def use_kernel(t, plain: bool) -> bool:
    return False


def check(*args) -> None:
    raise RuntimeError("the reference has no kernels")


def launch(*args) -> None:
    raise RuntimeError("the reference has no kernels")
