"""SAM's encoder attention (`rt3d_torch.models.sam.sam_attention`) on the
CPU: its plain version, which the wrapper takes for CPU tensors, against
the chain that computed it before the kernel, kept here as the yardstick:
`window_partition` (zero padding to whole windows), the (B, heads, N, N)
relative position bias of `rel_pos_bias`, `scaled_dot_product_attention`
with that bias, and `window_unpartition`.

Both sides run in float32 and differ only in the order of their sums (one
softmax and two matrix products against the fused attention), a few float32
roundings, about 1e-6 relative; `REL` (1e-5) leaves that ten times over.
The cases: a windowed block whose grid needs padding (grid 16, window 7,
padded to 21, 2 heads of 80), the padded keys and queries included; a
global block over a grid that is not square; tables read at a smaller size
than they were built for (a global block's 31-row tables in windows of 7,
as the benchmark's `sam_global_windowed` fault reads them); and no relative
terms. Then whole blocks (`Block.forward`: the padding, the attention on the
padded grid, the crop) against the old block, with no kernel launched."""

from typing import Tuple

import pytest
import torch
import torch.nn.functional as F

from rt3d_torch import kernels
from rt3d_torch.models import sam as P

REL = 1e-5
HEADS, HD = 2, 80
C = HEADS * HD


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


# -- the chain before the kernel -------------------------------------------------


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(win: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // ws // ws)
    x = win.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w, :]


def rel_pos_bias(q, rel_pos_h, rel_pos_w, hw):
    h, w = hw
    b, nh, _, hd = q.shape
    ih = torch.arange(h)
    iw = torch.arange(w)
    r_h = rel_pos_h[(ih[:, None] - ih[None, :]) + (h - 1)]
    r_w = rel_pos_w[(iw[:, None] - iw[None, :]) + (w - 1)]
    r_q = q.reshape(b, nh, h, w, hd)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, r_h)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, r_w)
    return (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, nh, h * w, h * w)


def old_attention(qkv: torch.Tensor, heads: int, rel_h, rel_w) -> torch.Tensor:
    """qkv (B, h, w, 3C) of one window (or the whole grid) -> (B, h, w, C)."""
    b, h, w, _ = qkv.shape
    q, k, v = qkv.reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4).unbind(0)
    bias = rel_pos_bias(q, rel_h, rel_w, (h, w)) if rel_h is not None else None
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    return out.transpose(1, 2).reshape(b, h, w, -1)


def old_block(blk: P.Block, x: torch.Tensor) -> torch.Tensor:
    shortcut = x
    x = blk.norm1(x)
    attn = blk.attn
    rel = (attn.rel_pos_h, attn.rel_pos_w) if attn.use_rel_pos else (None, None)

    def run(t):
        return attn.proj(old_attention(attn.qkv(t), attn.num_heads, *rel))

    if blk.window_size > 0:
        h, w = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, blk.window_size)
        x = window_unpartition(run(x), blk.window_size, pad_hw, (h, w))
    else:
        x = run(x)
    x = shortcut + x
    return x + blk.mlp(blk.norm2(x))


# -- the cases -----------------------------------------------------------------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def grid_qkv(seed, grid, pad_to):
    """The qkv Linear's output on a zero-padded grid, as the encoder makes
    it: random tokens (B 2), zero rows past `grid`, a random Linear (its
    bias makes the padded tokens' q, k and v nonzero)."""
    x = torch.randn((2, *grid, C), generator=_gen(seed))
    x = F.pad(x, (0, 0, 0, pad_to[1] - grid[1], 0, pad_to[0] - grid[0]))
    lin = torch.nn.Linear(C, 3 * C)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(lin.weight.shape, generator=_gen(seed + 1)) * 0.1)
        lin.bias.copy_(torch.randn(lin.bias.shape, generator=_gen(seed + 2)))
        return lin(x)


def tables(seed, size):
    """Tables of 2 * size - 1 rows, as a block built for `size` holds."""
    return (torch.randn((2 * size[0] - 1, HD), generator=_gen(seed)) * 0.1,
            torch.randn((2 * size[1] - 1, HD), generator=_gen(seed + 1)) * 0.1)


# name: (grid, window side (0: global), tables' size, relative terms)
CASES = {
    "windowed_padded": ((16, 16), 7, (7, 7), True),
    "global_not_square": ((9, 12), 0, (9, 12), True),
    "tables_of_a_larger_size": ((16, 16), 7, (16, 16), True),
    "no_relative_terms": ((16, 16), 7, (7, 7), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_the_old_chain(case):
    grid, ws, size, with_rel = CASES[case]
    pad = tuple(-(-g // ws) * ws for g in grid) if ws else grid
    window = (ws, ws) if ws else grid
    qkv = grid_qkv(3, grid, pad)
    rh, rw = tables(7, size) if with_rel else (None, None)
    got = P.sam_attention(qkv, HEADS, window, rh, rw)
    assert got.shape == (2, *pad, C) and got.dtype == qkv.dtype
    # the old chain over every window of the padded grid, padded rows kept
    if ws:
        win, pad_hw = window_partition(qkv, ws)
        assert pad_hw == pad
        want = window_unpartition(old_attention(win, HEADS, rh, rw), ws, pad, pad)
    else:
        want = old_attention(qkv, HEADS, rh, rw)
    assert rel(got, want) < REL
    assert torch.equal(got, P.sam_attention(qkv, HEADS, window, rh, rw, plain=True))


def test_the_terms_move_the_result():
    """The cases above tell the relative terms apart: dropping them, or
    reading the tables at the wrong size, moves the output far beyond REL."""
    qkv = grid_qkv(3, (16, 16), (21, 21))
    rh, rw = tables(7, (7, 7))
    with_terms = P.sam_attention(qkv, HEADS, (7, 7), rh, rw)
    assert rel(P.sam_attention(qkv, HEADS, (7, 7)), with_terms) > 1e-2
    big_h, big_w = tables(7, (16, 16))
    shifted = P.sam_attention(qkv, HEADS, (7, 7), big_h[9:], big_w[9:])
    assert rel(shifted, P.sam_attention(qkv, HEADS, (7, 7), big_h, big_w)) > 1e-2


def _block(window_size, grid, seed):
    sizes = P.SamSizes(image_size=16 * grid, embed_dim=C, num_heads=HEADS, mlp_dim=2 * C,
                       window_size=7)
    blk = P.Block(sizes, window_size)
    gen = _gen(seed)
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * (0.1 if prm.dim() > 1 else 1.0))
    return blk


@pytest.mark.parametrize("window_size", [7, 0])  # windowed (grid 16 padded to 21), global
def test_block_matches_the_old_block(window_size):
    blk = _block(window_size, 16, 11)
    x = torch.randn((2, 16, 16, C), generator=_gen(12))
    kernels.reset_launches()
    with torch.no_grad():
        got, want = blk(x), old_block(blk, x)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert got.shape == x.shape
    assert rel(got, want) < REL


def test_block_reads_window_size_at_call_time():
    """A global block set to attend in windows (the benchmark's fault)
    reads the first 13 rows of its 31-row tables, as the old block did."""
    blk = _block(0, 16, 13)
    blk.window_size = 7
    x = torch.randn((2, 16, 16, C), generator=_gen(14))
    assert blk.attn.rel_pos_h.shape[0] == 31
    with torch.no_grad():
        assert rel(blk(x), old_block(blk, x)) < REL
