"""Segment Anything (Kirillov et al., arXiv:2304.02643) as the step's mask
model: the detector's boxes prompt SAM on the same frame.

Follows `segment_anything` (`build_sam.py`, `modeling/image_encoder.py`,
`prompt_encoder.py`, `mask_decoder.py`, `transformer.py`, `sam.py` and
`utils/transforms.py`):

* the image encoder, a ViT of pre-norm blocks at 1024 x 1024 in patches of
  16 (a 64 x 64 grid): most blocks attend in windows (the grid padded to a
  multiple of the window), the blocks of `global_attn_indexes` over the
  whole grid; every attention adds SAM's decomposed relative position terms
  ``q . R_h`` and ``q . R_w`` to its logits, here inside one kernel a
  block (`sam_attention`) that reads q, k and v from the qkv Linear's
  output on the padded grid and writes into its layout; exact GELU,
  LayerNorm eps 1e-6; then the neck (conv 1x1, LayerNorm2d, conv 3x3,
  LayerNorm2d) to 256 channels;
* the prompt encoder, box prompts only: the random-Fourier encoding of the
  two corners (+0.5, the pixel centre) plus `point_embeddings[2]` and
  `[3]`; `no_mask_embed` as the dense embedding. The mask-input branch
  (`mask_downscaling`) is held so that the public checkpoint loads whole,
  and never runs;
* the mask decoder: the two-way transformer (token self-attention, token to
  image and image to token cross-attention at half width), the image
  embedding repeated once a prompt, the upscaling by two transposed convs,
  and the hypernetwork MLP and IoU head, with ``multimask_output=False``.
  Only mask token 0's hypernetwork and IoU output are computed, the ones
  that output keeps;
* preprocessing (`ResizeLongestSide.apply_image_torch`, normalisation,
  zero padding) and postprocessing (`Sam.postprocess_masks`, then ``> 0``).

Parameters carry the public checkpoint's key names (`image_encoder.*`,
`prompt_encoder.*`, `mask_decoder.*`), so `load_weights` takes
`sam_vit_h_4b8939.pth` unchanged. Without it, `init_random` draws them from
a seed by the rule written there, which the benchmark's plain reference
repeats.

The positional encodings are computed in float32 (the source does so for
the box corners), then cast to the model's dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rt3d_torch import kernels
from rt3d_torch.geometry.ops import scalar_like
from rt3d_torch.models.postprocess import Detections, in_boxes
from rt3d_torch.runtime import trace

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
# the head dim that the attention kernel takes (ViT-B, -L and -H: 64, 64
# and 80 wide heads; -H's is the one run here)
SAM_KERNEL_HEAD_DIM = 80


@dataclass(frozen=True)
class SamSizes:
    """One SAM model's sizes; the defaults are ViT-H's (`build_sam_vit_h`)."""

    image_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    prompt_embed_dim: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    mask_in_chans: int = 16
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


# the SAM models by the name `ModelConfig.mask_model` gives after its "sam_"
# prefix: `build_sam.py`'s ViT-H
SAM_SIZES: Dict[str, SamSizes] = {"vit_h": SamSizes()}

# the tensors that `init_random` draws from normal(0, 1), by a component of
# their key name; every other tensor of rank >= 2 from normal(0, 0.02)
UNIT_NORMAL = frozenset({"positional_encoding_gaussian_matrix", "point_embeddings",
                         "not_a_point_embed", "no_mask_embed", "iou_token", "mask_tokens"})


def sam_sizes(mask_model: str) -> SamSizes:
    """The sizes of `mask_model` ("sam_" and a name of `SAM_SIZES`)."""
    name = mask_model[4:] if mask_model.startswith("sam_") else None
    if name not in SAM_SIZES:
        raise ValueError(f"unknown mask_model {mask_model!r}; expected 'proto' or one of "
                         f"{', '.join('sam_' + k for k in SAM_SIZES)}")
    return SAM_SIZES[name]


# -- shared pieces --------------------------------------------------------------


def _channels(values, ref: torch.Tensor) -> torch.Tensor:
    """(3, 1, 1) of `values` in `ref`'s dtype, filled on its device (no
    copy from the host, so no synchronization)."""
    return torch.stack([torch.full((), v, dtype=ref.dtype, device=ref.device)
                        for v in values])[:, None, None]


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of (B, C, H, W)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, act=F.gelu):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class MLP(nn.Module):
    """`num_layers` Linears, ReLU between them."""

    def __init__(self, dim_in: int, hidden: int, dim_out: int, num_layers: int):
        super().__init__()
        dims = [dim_in] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [dim_out]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


# -- the image encoder ------------------------------------------------------------


def sam_attention_plain(qkv: torch.Tensor, num_heads: int, window: Tuple[int, int],
                        rel_h: Optional[torch.Tensor] = None,
                        rel_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of `sam_attention`: the same windows, terms,
    softmax and products, in float32, and the result in `qkv`'s dtype."""
    b, hp, wp, c3 = qkv.shape
    wh, ww = window
    nh, nw = hp // wh, wp // ww
    hd = c3 // 3 // num_heads
    # (3, B * windows * heads, wh * ww, hd): each window's tokens row by row
    t = qkv.view(b, nh, wh, nw, ww, 3, num_heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = t.reshape(3, -1, wh * ww, hd).float().unbind(0)
    logits = (q @ k.transpose(1, 2)) * hd ** -0.5
    if rel_h is not None:
        ih = torch.arange(wh, device=qkv.device)
        iw = torch.arange(ww, device=qkv.device)
        r_h = rel_h[(ih[:, None] - ih[None, :]) + (wh - 1)].float()  # (wh, wh, hd)
        r_w = rel_w[(iw[:, None] - iw[None, :]) + (ww - 1)].float()  # (ww, ww, hd)
        r_q = q.view(-1, wh, ww, hd)
        th = torch.einsum("nyxc,ykc->nyxk", r_q, r_h)
        tw = torch.einsum("nyxc,xkc->nyxk", r_q, r_w)
        logits = (logits.view(-1, wh, ww, wh, ww) + th[..., :, None] + tw[..., None, :]
                  ).view(-1, wh * ww, wh * ww)
    out = logits.softmax(-1) @ v
    out = out.view(b, nh, nw, num_heads, wh, ww, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return out.reshape(b, hp, wp, num_heads * hd).to(qkv.dtype)


def sam_attention(qkv: torch.Tensor, num_heads: int, window: Tuple[int, int],
                  rel_h: Optional[torch.Tensor] = None, rel_w: Optional[torch.Tensor] = None,
                  plain: bool = False) -> torch.Tensor:
    """SAM's attention with decomposed relative positions in windows of
    ``window = (wh, ww)`` tokens over a (B, Hp, Wp) grid; a global block is
    one window of the whole grid. qkv (B, Hp, Wp, 3 * C), the qkv Linear's
    output on the grid (zero-padded to whole windows), q, k and v of each
    token and head at ``[..., part * C + head * hd:][:hd]``; rel_h and rel_w
    the tables (their first 2 wh - 1 and 2 ww - 1 rows are read), or None
    for no relative terms -> (B, Hp, Wp, C): for each window and head
    ``softmax(scale q.k + q.R_h[row(q) - row(k) + wh - 1] + q.R_w[col(q) -
    col(k) + ww - 1]) v``, with q unscaled in the terms.

    On the card the kernel computes it (`rt3d_torch/csrc/sam_attention.cu`,
    `LAUNCHES["sam_attention"]`): bf16, contiguous, head dim 80, window
    sides up to 64 and an even width; anything else raises. A CPU tensor,
    or ``plain=True``, takes `sam_attention_plain`."""
    if not kernels.use_kernel(qkv, plain):
        return sam_attention_plain(qkv, num_heads, window, rel_h, rel_w)
    b, hp, wp, _ = qkv.shape
    wh, ww = window
    kernels.check(qkv, torch.bfloat16, (-1, -1, -1, 3 * num_heads * SAM_KERNEL_HEAD_DIM),
                  "sam_attention qkv")
    if not (0 < wh <= 64 and 0 < ww <= 64 and ww % 2 == 0 and hp % wh == 0 and wp % ww == 0):
        raise ValueError(f"sam_attention: windows of {wh} x {ww} over a {hp} x {wp} grid; the "
                         "kernel takes sides up to 64 that divide the grid, the width even")
    if (rel_h is None) != (rel_w is None):
        raise ValueError("sam_attention: give both relative position tables or neither")
    tables = []
    for name, tab, side in (("rel_h", rel_h, wh), ("rel_w", rel_w, ww)):
        if tab is not None:
            kernels.check(tab, torch.bfloat16, (-1, SAM_KERNEL_HEAD_DIM), f"sam_attention {name}")
            if tab.shape[0] < 2 * side - 1:
                raise ValueError(f"sam_attention {name}: {tab.shape[0]} rows, a window side of "
                                 f"{side} reads {2 * side - 1}")
        tables.append(None if tab is None else tab.data_ptr())
    if any(p % 16 for p in [qkv.data_ptr()] + [p for p in tables if p is not None]):
        raise ValueError("sam_attention: the kernel reads 16-byte aligned rows")
    out = torch.empty((b, hp, wp, num_heads * SAM_KERNEL_HEAD_DIM), dtype=qkv.dtype,
                      device=qkv.device)
    kernels.launch("sam_attention", "rt3d_sam_attention", qkv.data_ptr(), *tables,
                   out.data_ptr(), b, hp, wp, num_heads, wh, ww,
                   SAM_KERNEL_HEAD_DIM ** -0.5)
    return out


class Attention(nn.Module):
    """Multi-head self-attention over a (B, H, W, C) grid with SAM's
    relative position terms (`use_rel_pos`), in windows of the grid."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = True
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor, window: Tuple[int, int], plain: bool = False
                ) -> torch.Tensor:
        """x (B, Hp, Wp, C), whole windows of `window` -> (B, Hp, Wp, C)."""
        rel = (self.rel_pos_h, self.rel_pos_w) if self.use_rel_pos else (None, None)
        return self.proj(sam_attention(self.qkv(x), self.num_heads, window, *rel, plain=plain))


class Block(nn.Module):
    """Pre-norm transformer block; `window_size` 0 attends globally. A
    windowed block zero-pads the grid to whole windows, runs its attention
    (qkv and proj included) on the padded grid, and crops."""

    def __init__(self, s: SamSizes, window_size: int):
        super().__init__()
        size = (window_size, window_size) if window_size else (s.grid, s.grid)
        self.norm1 = nn.LayerNorm(s.embed_dim, eps=s.layer_norm_eps)
        self.attn = Attention(s.embed_dim, s.num_heads, size)
        self.norm2 = nn.LayerNorm(s.embed_dim, eps=s.layer_norm_eps)
        self.mlp = MLPBlock(s.embed_dim, s.mlp_dim)
        self.window_size = window_size

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        h, w = x.shape[1], x.shape[2]
        ws = self.window_size
        if ws > 0:
            ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
            if ph or pw:
                x = F.pad(x, (0, 0, 0, pw, 0, ph))
        x = shortcut + self.attn(x, (ws, ws) if ws > 0 else (h, w), plain)[:, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        self.proj = nn.Conv2d(3, s.embed_dim, s.patch_size, stride=s.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C), contiguous: the blocks' LayerNorms, residual adds
        and Linears then read it, and what they make, without copies."""
        return self.proj(x).permute(0, 2, 3, 1).contiguous()


class ImageEncoderViT(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        self.patch_embed = PatchEmbed(s)
        self.pos_embed = nn.Parameter(torch.zeros(1, s.grid, s.grid, s.embed_dim))
        self.blocks = nn.ModuleList(
            Block(s, 0 if i in s.global_attn_indexes else s.window_size) for i in range(s.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(s.embed_dim, s.prompt_embed_dim, 1, bias=False),
            LayerNorm2d(s.prompt_embed_dim, s.layer_norm_eps),
            nn.Conv2d(s.prompt_embed_dim, s.prompt_embed_dim, 3, padding=1, bias=False),
            LayerNorm2d(s.prompt_embed_dim, s.layer_norm_eps))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """(B, 3, S, S) normalised and padded -> (B, 256, S/16, S/16);
        ``plain=True`` takes the plain attention on the card too."""
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x, plain)
        return self.neck(x.permute(0, 3, 1, 2))


# -- the prompt encoder ----------------------------------------------------------


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn((2, num_pos_feats)))

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        """Coordinates in [0, 1], float32 -> (..., 2 * num_pos_feats)."""
        c = (2 * coords - 1) @ self.positional_encoding_gaussian_matrix.float()
        c = 2 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def dense(self, size: int) -> torch.Tensor:
        """(C, size, size): the encoding of every cell's centre."""
        dev = self.positional_encoding_gaussian_matrix.device
        t = (torch.arange(size, device=dev, dtype=torch.float32) + 0.5) / size
        grid = torch.stack([t[None, :].expand(size, size), t[:, None].expand(size, size)], -1)
        return self.encode(grid).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        d, m = s.prompt_embed_dim, s.mask_in_chans
        self.image_size = s.image_size
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, m // 4, 2, stride=2), LayerNorm2d(m // 4), nn.GELU(),
            nn.Conv2d(m // 4, m, 2, stride=2), LayerNorm2d(m), nn.GELU(),
            nn.Conv2d(m, d, 1))
        self.no_mask_embed = nn.Embedding(1, d)

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """(N, 4) boxes in the encoder's input pixels -> (N, 2, C) sparse
        embeddings of their two corners."""
        corners = (boxes.float() + 0.5).reshape(-1, 2, 2) / self.image_size
        pe = self.pe_layer.encode(corners)
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]]).float()
        return (pe + corner).to(self.no_mask_embed.weight.dtype)


# -- the mask decoder ------------------------------------------------------------


class DecoderAttention(nn.Module):
    """`transformer.Attention`: projections to `dim / downsample` wide,
    heads, and back."""

    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        out = F.scaled_dot_product_attention(self._heads(self.q_proj(q)),
                                             self._heads(self.k_proj(k)),
                                             self._heads(self.v_proj(v)))
        b, nh, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, nh * c))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, s: SamSizes, skip_first_layer_pe: bool):
        super().__init__()
        d, nh, r = s.prompt_embed_dim, s.decoder_heads, s.attention_downsample_rate
        self.self_attn = DecoderAttention(d, nh)
        self.norm1 = nn.LayerNorm(d)
        self.cross_attn_token_to_image = DecoderAttention(d, nh, r)
        self.norm2 = nn.LayerNorm(d)
        self.mlp = MLPBlock(d, s.decoder_mlp_dim, act=F.relu)
        self.norm3 = nn.LayerNorm(d)
        self.norm4 = nn.LayerNorm(d)
        self.cross_attn_image_to_token = DecoderAttention(d, nh, r)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(queries + query_pe, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, queries + query_pe, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        d = s.prompt_embed_dim
        self.layers = nn.ModuleList(TwoWayAttentionBlock(s, i == 0)
                                    for i in range(s.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(d, s.decoder_heads,
                                                          s.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(d)

    def forward(self, image, image_pe, tokens):
        """image and image_pe (B, C, h, w), tokens (B, T, C) -> (tokens,
        image tokens (B, h*w, C))."""
        keys = image.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        attn = self.final_attn_token_to_image(queries + tokens, keys + key_pe, keys)
        return self.norm_final_attn(queries + attn), keys


class MaskDecoder(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        d, n = s.prompt_embed_dim, s.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(s)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(n, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(d, d, d // 8, 3) for _ in range(n))
        self.iou_prediction_head = MLP(d, s.iou_head_hidden_dim, n, s.iou_head_depth)

    def forward(self, image: torch.Tensor, image_pe: torch.Tensor, sparse: torch.Tensor,
                dense: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image (N, C, h, w), one a prompt; image_pe (1, C, h, w); sparse
        (N, T, C); dense (1, C, 1, 1) -> mask 0's logits (N, 4h, 4w) and
        IoU prediction 0 (N,)."""
        n = sparse.shape[0]
        out = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out[None].expand(n, -1, -1), sparse], dim=1)
        src = image + dense
        b, c, h, w = src.shape
        hs, src = self.transformer(src, image_pe.expand(n, -1, -1, -1), tokens)
        up = self.output_upscaling(src.transpose(1, 2).reshape(b, c, h, w))
        hyper = self.output_hypernetworks_mlps[0](hs[:, 1])
        masks = torch.bmm(hyper[:, None], up.flatten(2)).reshape(b, up.shape[2], up.shape[3])
        return masks, self.iou_prediction_head(hs[:, 0])[:, 0]


class Sam(nn.Module):
    """The three parts under the public checkpoint's names, and SAM's
    pre- and postprocessing."""

    def __init__(self, s: SamSizes):
        super().__init__()
        self.sizes = s
        self.image_encoder = ImageEncoderViT(s)
        self.prompt_encoder = PromptEncoder(s)
        self.mask_decoder = MaskDecoder(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.image_encoder.pos_embed.dtype

    def input_hw(self, src_hw: Tuple[int, int]) -> Tuple[int, int]:
        """`ResizeLongestSide.get_preprocess_shape`: the longest side to
        `image_size`, the other scaled alike and rounded."""
        scale = self.sizes.image_size / max(src_hw)
        return int(src_hw[0] * scale + 0.5), int(src_hw[1] * scale + 0.5)

    def preprocess(self, rgb: torch.Tensor) -> torch.Tensor:
        """(C, H, W, 3) uint8 BGR -> (C, 3, S, S) in the model's dtype: RGB,
        resized bilinear with antialias so the longest side is S, normalised
        by SAM's pixel mean and std, zero-padded at the bottom and right."""
        x = rgb.flip(-1).permute(0, 3, 1, 2).float()
        x = F.interpolate(x, size=self.input_hw(tuple(rgb.shape[1:3])), mode="bilinear",
                          align_corners=False, antialias=True)
        x = (x - _channels(PIXEL_MEAN, x)) / _channels(PIXEL_STD, x)
        s = self.sizes.image_size
        x = F.pad(x, (0, s - x.shape[3], 0, s - x.shape[2]))
        return x.to(self.dtype)

    def dense_pe(self) -> torch.Tensor:
        """(1, C, grid, grid) `get_dense_pe`, in the model's dtype."""
        return self.prompt_encoder.pe_layer.dense(self.sizes.grid)[None].to(self.dtype)

    def decode_boxes(self, embeddings: torch.Tensor, boxes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """embeddings (C, 256, h, w); boxes (C, D, 4) in the encoder's input
        pixels -> every box's low-resolution logits (C, D, 4h, 4w) and IoU
        prediction (C, D), in the model's dtype."""
        c, d = boxes.shape[:2]
        sparse = self.prompt_encoder.embed_boxes(boxes.reshape(c * d, 4))
        dense = self.prompt_encoder.no_mask_embed.weight.reshape(1, -1, 1, 1)
        shape = embeddings.shape[1:]
        image = embeddings[:, None].expand(c, d, *shape).reshape(c * d, *shape)
        low, iou = self.mask_decoder(image, self.dense_pe(), sparse, dense)
        return low.reshape(c, d, *low.shape[1:]), iou.reshape(c, d)

    def postprocess(self, low: torch.Tensor, src_hw: Tuple[int, int],
                    dtype: torch.dtype) -> torch.Tensor:
        """`Sam.postprocess_masks` then ``> 0``: (C, D, h, w) logits ->
        (C, D, H, W) bool; bilinear to S x S, the padding cropped, bilinear
        to the source size, each resize in `dtype`."""
        c, d = low.shape[:2]
        s = self.sizes.image_size
        m = F.interpolate(low.reshape(c * d, 1, *low.shape[2:]).to(dtype), size=(s, s),
                          mode="bilinear", align_corners=False)
        nh, nw = self.input_hw(src_hw)
        m = F.interpolate(m[..., :nh, :nw], size=tuple(src_hw), mode="bilinear",
                          align_corners=False)
        return (m > 0).reshape(c, d, *src_hw)


class SamMasks:
    """SAM as the step's mask model (see `postprocess.ProtoMasks`): it
    decodes every box slot, valid or not, at a fixed shape, then cuts each
    mask to its box and its slot's validity. ``plain=True`` runs the
    encoder's attention in its plain version (`Pipeline.plain_kernels`)."""

    def __init__(self, sam: Sam, src_hw: Tuple[int, int], resize_dtype: torch.dtype,
                 plain: bool = False):
        self.sam, self.src_hw, self.resize_dtype, self.plain = sam, src_hw, resize_dtype, plain

    def context(self, rgb: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
        """(C, 256, 64, 64) embeddings, the cameras as one batch: SAM's
        preprocessing, then its encoder."""
        with trace.span("sam.preprocess"):
            x = self.sam.preprocess(rgb)
        with trace.device_span("sam.encoder", x.device):
            emb = self.sam.image_encoder(x, self.plain)
        trace.count("sam_encoder_images", x.shape[0])
        return emb

    def masks(self, embeddings: torch.Tensor, det: Detections
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The masks, and the low-resolution logits (C, D, 256, 256)."""
        sam, src_hw = self.sam, self.src_hw
        with trace.span("sam.decoder"):
            # `ResizeLongestSide.apply_boxes`: x and y scaled as the image
            (nh, nw) = sam.input_hw(src_hw)
            sx, sy = scalar_like(nw / src_hw[1], det.boxes), scalar_like(nh / src_hw[0], det.boxes)
            scale = torch.stack([sx, sy, sx, sy])
            low, _ = sam.decode_boxes(embeddings, det.boxes * scale)
        trace.count("sam_prompt_slots", det.boxes.shape[0] * det.boxes.shape[1])
        with trace.span("sam.postprocess"):
            out = sam.postprocess(low, src_hw, self.resize_dtype) & in_boxes(det.boxes, src_hw) \
                & det.valid[:, :, None, None]
        return out, low


def init_random(sam: Sam, seed: int) -> Sam:
    """The benchmark's rule for random weights: one generator on the
    model's device, seeded with `seed`, walks the public key names in
    sorted order and draws, in float32, normal(0, 1) for the tensors named
    in `UNIT_NORMAL` and normal(0, 0.02) for every other tensor of rank
    >= 2 (`pos_embed` and the `rel_pos_*` tables among them); norm weights
    are 1 and biases 0."""
    sd = sam.state_dict()
    dev = next(iter(sd.values())).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name in sorted(sd):
            t = sd[name]
            if t.dim() >= 2:
                std = 1.0 if UNIT_NORMAL & set(name.split(".")) else 0.02
                t.copy_(torch.randn(t.shape, generator=gen, device=dev) * std)
            else:
                t.fill_(0.0 if name.endswith("bias") else 1.0)
    return sam


def load_weights(sam: Sam, path: str) -> Sam:
    """The public checkpoint (`sam_vit_h_4b8939.pth`): its three parts'
    tensors, every one of them, by name."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    parts = ("image_encoder", "prompt_encoder", "mask_decoder")
    sam.load_state_dict({k: v for k, v in sd.items() if k.split(".")[0] in parts}, strict=True)
    return sam


def build_sam(mask_model: str, dtype: torch.dtype, device, seed: int = 0,
              weights: Optional[str] = None) -> Sam:
    """SAM of `mask_model`'s sizes on `device` in `dtype`, from `weights`
    when given, else random from `seed`."""
    device = torch.device(device)
    with torch.device("meta"):
        sam = Sam(sam_sizes(mask_model))
    if weights:
        sam = load_weights(sam.to_empty(device="cpu"), weights)
    else:
        sam = init_random(sam.to_empty(device=device), seed)
    return sam.to(device=device, dtype=dtype).eval().requires_grad_(False)
