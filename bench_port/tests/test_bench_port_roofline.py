"""`bench_port.roofline` gives the chip smoke test's bounds on its phase 3
worst-case inputs (built here on the CPU the way phase 3 builds them)."""

import os
import sys

import pytest
import torch

from bench_port import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def inputs():
    from rt3d_torch.geometry.ops import INT_SENTINEL

    gen = torch.Generator().manual_seed(0)

    def key_grid(h, w):
        r = torch.arange(h)[:, None] // 3
        c = torch.arange(w)[None, :] // 5
        kg = (r * 4096 + c).to(torch.int32)
        kg = kg + torch.randint(0, 2, (h, w), generator=gen, dtype=torch.int32)
        sent = torch.rand((h, w), generator=gen) < 0.3
        return torch.where(sent, INT_SENTINEL, kg).to(torch.int32)

    k1, k2 = key_grid(360, 640), key_grid(720, 1280)
    w2 = torch.randint(1, 2**20, (720, 1280), generator=gen, dtype=torch.int32)
    w2 = torch.where(k2 == INT_SENTINEL, 0, w2).to(torch.int32)
    s, cap = 20, 2048
    lat = torch.randint(-20, 20, (s, cap, 3), generator=gen).float() * 0.005
    pts = (lat + torch.rand((s, 1, 3), generator=gen) * 0.6
           + torch.randn((s, cap, 3), generator=gen) * 0.001).contiguous()
    n_valid = torch.tensor([1500, 900, 700, 400, 300, 120, 15] + [0] * (s - 7))
    valid = torch.arange(cap)[None, :] < n_valid[:, None]
    q = (torch.randint(-100, 150, (131072, 3), generator=gen).float() * 0.005).contiguous()
    r = torch.zeros((20480, 3))
    r[:3000] = torch.randint(0, 40, (3000, 3), generator=gen).float() * 0.005
    rv = torch.arange(20480) < 3000
    c5 = torch.randint(-20, 20, (2048, 3), generator=gen).float() * 0.005 + 0.3
    c5v = torch.rand(2048, generator=gen) >= 0.3
    return dict(k1=k1, k2=k2, w2=w2, pts=pts, valid=valid, q=q, r=r, rv=rv, c5=c5, c5v=c5v)


def test_k1_k2(smoke, inputs):
    x = inputs
    assert roofline.k1_bound(x["k1"]) == smoke.bound(8 * x["k1"].numel(),
                                                     int_ops=smoke.window_ops(torch, x["k1"]))
    assert roofline.k2_bound(x["k2"], x["w2"]) == smoke.bound(
        12 * x["k2"].numel(), int_ops=smoke.window_ops(torch, x["k2"], x["w2"]))
    for win in ((5, 6), (8, 12)):
        assert roofline.window_ops(x["k2"], x["w2"], win) == smoke.window_ops(
            torch, x["k2"], x["w2"], win)


def test_k3_k5(smoke, inputs):
    pts, valid = inputs["pts"], inputs["valid"]
    s, cap, _ = pts.shape
    pairs = int((valid.sum(-1).long() ** 2).sum())
    assert roofline.k3_bound(pts, valid) == smoke.bound(s * cap * (12 + 1 + 4 + 1), pairs * 10)
    c, cv = inputs["c5"], inputs["c5v"]
    assert roofline.k5_bound(c, cv) == smoke.bound(c.shape[0] * (12 + 1 + 4 + 1),
                                                   int(cv.sum()) ** 2 * 10)


def test_k4(smoke, inputs):
    q, r, rv = inputs["q"], inputs["r"], inputs["rv"]
    qv = torch.ones(q.shape[0], dtype=torch.bool)
    t = torch.tensor(0.06, dtype=torch.float32)
    t2 = t * t
    assert roofline.k4_pairs(q, qv, r, rv, t2) == smoke.k4_pairs(torch, q, qv, r, rv, t2)
    _, kept = smoke.k4_pairs(torch, q, qv, r, rv, t2)
    want = smoke.bound(q.shape[0] * (12 + 1 + 4) + r.shape[0] * (12 + 1), kept * 9)
    assert roofline.k4_bound(q, qv, r, rv, 0.06) == want
    assert roofline.call_bound("min_sqdist", (q, r, rv),
                               dict(threshold=0.06, query_valid=qv, plain=False)) == want


def test_kernel_names():
    assert roofline.is_kernel("void window_kernel<true>(int const*, int*)")
    assert roofline.is_kernel("min_d2_kernel(float const*, unsigned char const*)")
    assert not roofline.is_kernel("void at::native::vectorized_elementwise_kernel<4>")
