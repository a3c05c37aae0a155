"""SAM's encoder attention kernel (`rt3d_torch/csrc/sam_attention.cu`) on
the card, against its plain version (`sam_attention_plain`) at ViT-H's
shapes, in bf16.

Marked ``cuda``; each test skips without a CUDA device (this module imports
no JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_sam_attention_cuda.py

Tolerance. Both sides read the same bf16 q, k, v and tables and sum their
products in float32; the plain version keeps the softmax's probabilities in
float32, the kernel rounds them to bf16 as the operand of its p.v product
(2^-9 relative each), and each side rounds its output to bf16 (2^-9). The
two differ by a few such roundings, about 3e-3 relative (L2); `TOL` (1e-2)
leaves three times that. Each comparison also shows that `TOL` tells a
wrong kernel apart: the relative terms dropped move the plain version
twenty times `TOL` or more.

The cases: the global block (64 x 64, B 2, 16 heads, 127-row tables); the
windowed block on the 70 x 70 grid padded from 64 (25 windows of 14 x 14 an
image), its padded tokens holding one vector as the qkv Linear's bias gives
them, the padded keys taking part and the padded queries compared too; and
the benchmark's `sam_global_windowed` fault, a global block's 127-row
tables read in windows of 14 (their first 27 rows). Then the wrapper's
refusals, one launch a block (32 an encoder call, no
`scaled_dot_product_attention`), and the memory one global block takes.
"""

import pytest
import torch
import torch.nn.functional as F

from rt3d_torch import kernels
from rt3d_torch.models import sam as P

pytestmark = pytest.mark.cuda

HEADS, HD = 16, 80
C = HEADS * HD
TOL = 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def grid_qkv(seed, grid, pad):
    """(2, pad, pad, 3C) bf16: random q, k and v (std 1.5, so that the
    softmax is not flat) on the grid, one random vector on its padding."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((2, pad, pad, 3 * C), generator=gen, device="cuda") * 1.5
    bias = torch.randn((3 * C,), generator=gen, device="cuda")
    qkv[:, grid:] = bias
    qkv[:, :, grid:] = bias
    return qkv.to(torch.bfloat16)


def grid_tables(seed, rows):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple((torch.randn((rows, HD), generator=gen, device="cuda") * 0.1)
                 .to(torch.bfloat16) for _ in range(2))


# name: (grid, padded grid, window side, table rows)
CASES = {
    "global": (64, 64, 64, 127),
    "windowed_padded": (64, 70, 14, 27),
    "global_in_windows": (64, 70, 14, 127),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(card, case):
    grid, pad, ws, rows = CASES[case]
    qkv = grid_qkv(1, grid, pad)
    rh, rw = grid_tables(2, rows)
    before = kernels.LAUNCHES["sam_attention"]
    got = P.sam_attention(qkv, HEADS, (ws, ws), rh, rw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sam_attention"] == before + 1
    assert got.shape == (2, pad, pad, C) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    want = P.sam_attention(qkv, HEADS, (ws, ws), rh, rw, plain=True)
    assert kernels.LAUNCHES["sam_attention"] == before + 1
    err = rel(got, want)
    assert err < TOL, f"{case}: relative L2 {err:.3e}"
    assert rel(P.sam_attention_plain(qkv, HEADS, (ws, ws)), want) > 20 * TOL


def test_kernel_without_terms_matches_plain_version(card):
    qkv = grid_qkv(3, 64, 70)
    got = P.sam_attention(qkv, HEADS, (14, 14))
    assert rel(got, P.sam_attention_plain(qkv, HEADS, (14, 14))) < TOL


def test_refuses_what_it_cannot_take(card):
    qkv = grid_qkv(4, 64, 64)
    rh, rw = grid_tables(5, 127)
    before = dict(kernels.LAUNCHES)
    bad = [
        (TypeError, dict(qkv=qkv.float())),
        (ValueError, dict(qkv=torch.cat([qkv, qkv], 2)[:, :, :64])),  # strided
        (ValueError, dict(qkv=qkv[..., :3 * HEADS * 64].contiguous())),  # head dim 64
        (ValueError, dict(window=(14, 14))),  # 14 does not divide 64
        (ValueError, dict(window=(64, 1))),  # an odd width
        (ValueError, dict(qkv=torch.cat([qkv, qkv], 1), window=(128, 64))),  # side over 64
        (ValueError, dict(rel_w=None)),
        (ValueError, dict(rel_h=rh[:100])),  # 127 rows read
        (TypeError, dict(rel_h=rh.float())),
    ]
    for exc, kw in bad:
        args = {**dict(qkv=qkv, window=(64, 64), rel_h=rh, rel_w=rw), **kw}
        with pytest.raises(exc):
            P.sam_attention(args["qkv"], HEADS, args["window"], args["rel_h"], args["rel_w"])
    assert kernels.LAUNCHES == before


def test_one_launch_a_block_and_no_library_attention(card, monkeypatch):
    """ViT-H's encoder (bf16, random weights by the benchmark's rule) on two
    images: 32 launches, and no `scaled_dot_product_attention` call."""
    sam = P.build_sam("sam_vit_h", torch.bfloat16, "cuda", seed=20304)
    x = torch.randn((2, 3, 1024, 1024), generator=torch.Generator(device="cuda").manual_seed(6),
                    device="cuda").to(torch.bfloat16)

    def refuse(*args, **kwargs):
        raise AssertionError("the encoder called scaled_dot_product_attention")

    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    before = kernels.LAUNCHES["sam_attention"]
    emb = sam.image_encoder(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sam_attention"] - before == 32
    assert emb.shape == (2, 256, 64, 64) and bool(torch.isfinite(emb).all())
    assert not hasattr(P, "rel_pos_bias")


def test_global_block_allocates_no_square_buffer(card):
    """One global block's attention allocates its output (21 MB) and
    nothing of the (2, 16, 4096, 4096) bias (1.07 GB in bf16) the old chain
    built."""
    qkv = grid_qkv(7, 64, 64)
    rh, rw = grid_tables(8, 127)
    P.sam_attention(qkv, HEADS, (64, 64), rh, rw)  # built and loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    P.sam_attention(qkv, HEADS, (64, 64), rh, rw)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 64 * 2 ** 20
