"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device (this module imports
no JAX, so it also runs where only the port is installed):

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from rt3d_torch import kernels
from rt3d_torch.geometry import ops, sor, subtract

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(7)


def _keys(gen, h, w, sent=0.3):
    kg = torch.randint(0, 50, (h, w), device="cuda", generator=gen, dtype=torch.int32)
    mask = torch.rand((h, w), device="cuda", generator=gen) < sent
    return torch.where(mask, ops.INT_SENTINEL, kg).to(torch.int32)


@pytest.mark.parametrize("h,w,dy,dx", [(360, 640, 4, 6), (37, 53, 4, 6), (24, 128, 2, 3),
                                       (9, 40, 0, 1)])
def test_window_kernels_equal_plain(gen, h, w, dy, dx):
    kg = _keys(gen, h, w)
    wg = torch.randint(0, 2**20, (h, w), device="cuda", generator=gen, dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(ops.window_dedupe(kg, dy, dx), ops.window_dedupe(kg, dy, dx, plain=True))
    assert torch.equal(ops.window_prev_or(kg, wg, dy, dx),
                       ops.window_prev_or(kg, wg, dy, dx, plain=True))
    assert kernels.LAUNCHES["window_dedupe"] == before["window_dedupe"] + 1
    assert kernels.LAUNCHES["window_prev_or"] == before["window_prev_or"] + 1


@pytest.mark.parametrize("s,cap,k", [(20, 2048, 20), (3, 512, 20), (2, 300, 7), (1, 5000, 32)])
def test_sor_knn_equals_plain(gen, s, cap, k):
    pts = (torch.randint(-30, 30, (s, cap, 3), device="cuda", generator=gen).float() * 0.005
           + torch.randn((s, cap, 3), device="cuda", generator=gen) * 1e-3).contiguous()
    n = torch.randint(0, cap + 1, (s, 1), device="cuda", generator=gen)
    valid = torch.arange(cap, device="cuda")[None] < n
    mean, sat = sor.sor_knn_mean_slots(pts, valid, k)
    pmean, psat = sor.sor_knn_mean_slots(pts, valid, k, plain=True)
    assert torch.equal(sat, psat)
    assert torch.equal(mean, pmean)


@pytest.mark.parametrize("n,m,nvalid", [(131072, 20480, 3000), (1000, 1500, 0), (77, 3, 3)])
def test_min_sqdist_equals_plain(gen, n, m, nvalid):
    q = (torch.randint(-100, 100, (n, 3), device="cuda", generator=gen).float() * 0.005).contiguous()
    r = (torch.randint(-40, 40, (m, 3), device="cuda", generator=gen).float() * 0.005).contiguous()
    rv = torch.arange(m, device="cuda") < nvalid
    assert torch.equal(subtract.min_sqdist(q, r, rv), subtract.min_sqdist(q, r, rv, plain=True))


def test_wrappers_reject_bad_tensors(gen):
    kg = _keys(gen, 16, 16)
    with pytest.raises(TypeError):
        ops.window_dedupe(kg.long())
    with pytest.raises(ValueError):
        ops.window_dedupe(kg.t())
    with pytest.raises(ValueError):
        sor.sor_knn_mean_slots(torch.zeros(1, 8, 3, device="cuda"),
                               torch.ones(1, 8, dtype=torch.bool, device="cuda"), 40)
