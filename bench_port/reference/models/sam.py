"""A plain float32 Segment Anything (Kirillov et al., arXiv:2304.02643),
written from the published source (`segment_anything`: `build_sam.py`,
`modeling/image_encoder.py`, `prompt_encoder.py`, `mask_decoder.py`,
`transformer.py`, `common.py`, `sam.py`, `utils/transforms.py`), for the
benchmark's comparison. Plain `torch` operations only: attention as
``softmax((q * scale) @ k^T + rel) @ v``, the relative position terms added
to the logits as `add_decomposed_rel_pos` adds them, LayerNorm2d by hand.

Parameters carry the public checkpoint's key names. Random weights follow
the rule the program's `init_random` states (one generator on the model's
device, seeded with the seed, the key names in sorted order; normal(0, 1)
for `UNIT_NORMAL`, normal(0, 0.02) for every other tensor of rank >= 2,
norm weights 1, biases 0).

Departures from the source, none of which changes a number it computes:
* box prompts only: `PromptEncoder.forward` with points or a mask input is
  not written (the mask branch's parameters are held, so a checkpoint
  loads whole);
* `get_rel_pos` without its resize of a table of another length: every
  block here attends at the size it was built for;
* the sizes come as `SamSizes` (the configuration file's `sam` block), not
  as `build_sam.py`'s arguments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
UNIT_NORMAL = ("positional_encoding_gaussian_matrix", "point_embeddings", "not_a_point_embed",
               "no_mask_embed", "iou_token", "mask_tokens")


@dataclass(frozen=True)
class SamSizes:
    image_size: int
    patch_size: int
    embed_dim: int
    depth: int
    num_heads: int
    mlp_dim: int
    window_size: int
    global_attn_indexes: Tuple[int, ...]
    prompt_embed_dim: int
    decoder_depth: int
    decoder_heads: int
    decoder_mlp_dim: int
    attention_downsample_rate: int
    num_multimask_outputs: int
    iou_head_depth: int
    iou_head_hidden_dim: int
    mask_in_chans: int
    layer_norm_eps: float

    @staticmethod
    def from_dict(d: Dict) -> "SamSizes":
        return SamSizes(**{**d, "global_attn_indexes": tuple(d["global_attn_indexes"])})


class LayerNorm2d(nn.Module):
    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLPBlock(nn.Module):
    def __init__(self, embedding_dim: int, mlp_dim: int, act=nn.GELU):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)
        self.act = act()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class MLP(nn.Module):
    def __init__(self, input_dim, hidden_dim, output_dim, num_layers):
        super().__init__()
        self.num_layers = num_layers
        h = [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(n, k)
                                    for n, k in zip([input_dim] + h, h + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = F.relu(layer(x)) if i < self.num_layers - 1 else layer(x)
        return x


# -- image encoder -----------------------------------------------------------------


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative_coords.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return attn.view(B, q_h * q_w, k_h * k_w)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, input_size):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.num_heads, H * W, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W))
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(B, self.num_heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self.proj(x)


def window_partition(x, window_size):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


class Block(nn.Module):
    def __init__(self, s: SamSizes, window_size: int):
        super().__init__()
        grid = s.image_size // s.patch_size
        self.norm1 = nn.LayerNorm(s.embed_dim, eps=s.layer_norm_eps)
        self.attn = Attention(s.embed_dim, s.num_heads,
                              (grid, grid) if window_size == 0 else (window_size, window_size))
        self.norm2 = nn.LayerNorm(s.embed_dim, eps=s.layer_norm_eps)
        self.mlp = MLPBlock(s.embed_dim, s.mlp_dim)
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        self.proj = nn.Conv2d(3, s.embed_dim, kernel_size=s.patch_size, stride=s.patch_size)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        grid = s.image_size // s.patch_size
        self.patch_embed = PatchEmbed(s)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, s.embed_dim))
        self.blocks = nn.ModuleList(
            Block(s, 0 if i in s.global_attn_indexes else s.window_size) for i in range(s.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(s.embed_dim, s.prompt_embed_dim, kernel_size=1, bias=False),
            LayerNorm2d(s.prompt_embed_dim),
            nn.Conv2d(s.prompt_embed_dim, s.prompt_embed_dim, kernel_size=3, padding=1,
                      bias=False),
            LayerNorm2d(s.prompt_embed_dim))

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# -- prompt encoder ------------------------------------------------------------------


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.randn((2, num_pos_feats)))

    def _pe_encoding(self, coords):
        coords = 2 * coords - 1
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def forward(self, size):
        h, w = size
        grid = torch.ones((h, w), device=self.positional_encoding_gaussian_matrix.device,
                          dtype=torch.float32)
        y_embed = (grid.cumsum(dim=0) - 0.5) / h
        x_embed = (grid.cumsum(dim=1) - 0.5) / w
        pe = self._pe_encoding(torch.stack([x_embed, y_embed], dim=-1))
        return pe.permute(2, 0, 1)

    def forward_with_coords(self, coords_input, image_size):
        coords = coords_input.clone()
        coords[:, :, 0] = coords[:, :, 0] / image_size[1]
        coords[:, :, 1] = coords[:, :, 1] / image_size[0]
        return self._pe_encoding(coords.to(torch.float))


class PromptEncoder(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        embed_dim, mask_in_chans = s.prompt_embed_dim, s.mask_in_chans
        self.embed_dim = embed_dim
        self.input_image_size = (s.image_size, s.image_size)
        grid = s.image_size // s.patch_size
        self.image_embedding_size = (grid, grid)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, kernel_size=2, stride=2),
            LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, kernel_size=2, stride=2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, kernel_size=1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self):
        return self.pe_layer(self.image_embedding_size).unsqueeze(0)

    def _embed_boxes(self, boxes):
        boxes = boxes + 0.5
        coords = boxes.reshape(-1, 2, 2)
        corner_embedding = self.pe_layer.forward_with_coords(coords, self.input_image_size)
        corner_embedding[:, 0, :] += self.point_embeddings[2].weight
        corner_embedding[:, 1, :] += self.point_embeddings[3].weight
        return corner_embedding

    def forward(self, boxes):
        """Box prompts only: (sparse (B, 2, C), dense (B, C, h, w))."""
        bs = boxes.shape[0]
        sparse = torch.empty((bs, 0, self.embed_dim), device=boxes.device)
        sparse = torch.cat([sparse, self._embed_boxes(boxes)], dim=1)
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            bs, -1, self.image_embedding_size[0], self.image_embedding_size[1])
        return sparse, dense


# -- mask decoder ----------------------------------------------------------------------


class DecoderAttention(nn.Module):
    def __init__(self, embedding_dim, num_heads, downsample_rate=1):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.k_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.v_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.out_proj = nn.Linear(self.internal_dim, embedding_dim)

    def _separate_heads(self, x, num_heads):
        b, n, c = x.shape
        return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)

    def _recombine_heads(self, x):
        b, n_heads, n_tokens, c_per_head = x.shape
        return x.transpose(1, 2).reshape(b, n_tokens, n_heads * c_per_head)

    def forward(self, q, k, v):
        q = self._separate_heads(self.q_proj(q), self.num_heads)
        k = self._separate_heads(self.k_proj(k), self.num_heads)
        v = self._separate_heads(self.v_proj(v), self.num_heads)
        _, _, _, c_per_head = q.shape
        attn = q @ k.permute(0, 1, 3, 2)
        attn = attn / math.sqrt(c_per_head)
        attn = torch.softmax(attn, dim=-1)
        return self.out_proj(self._recombine_heads(attn @ v))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, s: SamSizes, skip_first_layer_pe: bool):
        super().__init__()
        d, nh, r = s.prompt_embed_dim, s.decoder_heads, s.attention_downsample_rate
        self.self_attn = DecoderAttention(d, nh)
        self.norm1 = nn.LayerNorm(d)
        self.cross_attn_token_to_image = DecoderAttention(d, nh, downsample_rate=r)
        self.norm2 = nn.LayerNorm(d)
        self.mlp = MLPBlock(d, s.decoder_mlp_dim, nn.ReLU)
        self.norm3 = nn.LayerNorm(d)
        self.norm4 = nn.LayerNorm(d)
        self.cross_attn_image_to_token = DecoderAttention(d, nh, downsample_rate=r)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(q=queries, k=queries, v=queries)
        else:
            q = queries + query_pe
            attn_out = self.self_attn(q=q, k=q, v=queries)
            queries = queries + attn_out
        queries = self.norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        attn_out = self.cross_attn_token_to_image(q=q, k=k, v=keys)
        queries = queries + attn_out
        queries = self.norm2(queries)
        mlp_out = self.mlp(queries)
        queries = queries + mlp_out
        queries = self.norm3(queries)
        q = queries + query_pe
        k = keys + key_pe
        attn_out = self.cross_attn_image_to_token(q=k, k=q, v=queries)
        keys = keys + attn_out
        keys = self.norm4(keys)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        d = s.prompt_embed_dim
        self.layers = nn.ModuleList(TwoWayAttentionBlock(s, skip_first_layer_pe=(i == 0))
                                    for i in range(s.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(
            d, s.decoder_heads, downsample_rate=s.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(d)

    def forward(self, image_embedding, image_pe, point_embedding):
        image_embedding = image_embedding.flatten(2).permute(0, 2, 1)
        image_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries=queries, keys=keys, query_pe=point_embedding,
                                  key_pe=image_pe)
        q = queries + point_embedding
        k = keys + image_pe
        attn_out = self.final_attn_token_to_image(q=q, k=k, v=keys)
        queries = self.norm_final_attn(queries + attn_out)
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        d = s.prompt_embed_dim
        self.transformer = TwoWayTransformer(s)
        self.num_mask_tokens = s.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, kernel_size=2, stride=2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, kernel_size=2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(d, s.iou_head_hidden_dim, self.num_mask_tokens,
                                       s.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings):
        """`multimask_output=False`: mask 0 and IoU prediction 0."""
        masks, iou_pred = self.predict_masks(image_embeddings, image_pe,
                                             sparse_prompt_embeddings, dense_prompt_embeddings)
        return masks[:, 0:1], iou_pred[:, 0:1]

    def predict_masks(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                      dense_prompt_embeddings):
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        output_tokens = output_tokens.unsqueeze(0).expand(sparse_prompt_embeddings.size(0), -1, -1)
        tokens = torch.cat((output_tokens, sparse_prompt_embeddings), dim=1)
        src = torch.repeat_interleave(image_embeddings, tokens.shape[0], dim=0)
        src = src + dense_prompt_embeddings
        pos_src = torch.repeat_interleave(image_pe, tokens.shape[0], dim=0)
        b, c, h, w = src.shape
        hs, src = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:(1 + self.num_mask_tokens), :]
        src = src.transpose(1, 2).reshape(b, c, h, w)
        upscaled_embedding = self.output_upscaling(src)
        hyper_in = torch.stack([self.output_hypernetworks_mlps[i](mask_tokens_out[:, i, :])
                                for i in range(self.num_mask_tokens)], dim=1)
        b, c, h, w = upscaled_embedding.shape
        masks = (hyper_in @ upscaled_embedding.view(b, c, h * w)).view(b, -1, h, w)
        return masks, self.iou_prediction_head(iou_token_out)


class Sam(nn.Module):
    def __init__(self, s: SamSizes):
        super().__init__()
        self.sizes = s
        self.image_encoder = ImageEncoderViT(s)
        self.prompt_encoder = PromptEncoder(s)
        self.mask_decoder = MaskDecoder(s)

    def get_preprocess_shape(self, oldh: int, oldw: int) -> Tuple[int, int]:
        scale = self.sizes.image_size * 1.0 / max(oldh, oldw)
        newh, neww = oldh * scale, oldw * scale
        return int(newh + 0.5), int(neww + 0.5)

    def preprocess(self, rgb: torch.Tensor) -> torch.Tensor:
        """(C, H, W, 3) uint8 BGR frames -> (C, 3, S, S) float32:
        `apply_image_torch`, then `Sam.preprocess`."""
        image = rgb.flip(-1).permute(0, 3, 1, 2).float()
        image = F.interpolate(image, self.get_preprocess_shape(*image.shape[2:]),
                              mode="bilinear", align_corners=False, antialias=True)
        mean = torch.tensor(PIXEL_MEAN, device=image.device).view(-1, 1, 1)
        std = torch.tensor(PIXEL_STD, device=image.device).view(-1, 1, 1)
        x = (image - mean) / std
        h, w = x.shape[-2:]
        s = self.sizes.image_size
        return F.pad(x, (0, s - w, 0, s - h))

    def apply_boxes(self, boxes: torch.Tensor, original_size) -> torch.Tensor:
        """`ResizeLongestSide.apply_boxes_torch`: (..., 4) boxes in original
        pixels -> the encoder's input pixels."""
        old_h, old_w = original_size
        new_h, new_w = self.get_preprocess_shape(old_h, old_w)
        coords = boxes.reshape(-1, 2, 2).clone().float()
        coords[..., 0] = coords[..., 0] * (new_w / old_w)
        coords[..., 1] = coords[..., 1] * (new_h / old_h)
        return coords.reshape(boxes.shape)

    def low_res_logits(self, embedding: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """One image's embedding (1, C, h, w) and its (N, 4) boxes in the
        encoder's input pixels -> mask 0's logits (N, 1, 4h, 4w)."""
        sparse, dense = self.prompt_encoder(boxes)
        masks, _ = self.mask_decoder(embedding, self.prompt_encoder.get_dense_pe(), sparse, dense)
        return masks

    def iou_predictions(self, embedding: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        sparse, dense = self.prompt_encoder(boxes)
        return self.mask_decoder(embedding, self.prompt_encoder.get_dense_pe(), sparse, dense)[1]

    def postprocess_masks(self, masks, input_size, original_size):
        s = self.sizes.image_size
        masks = F.interpolate(masks, (s, s), mode="bilinear", align_corners=False)
        masks = masks[..., :input_size[0], :input_size[1]]
        return F.interpolate(masks, original_size, mode="bilinear", align_corners=False)


def init_random(sam: Sam, seed: int) -> Sam:
    sd = sam.state_dict()
    device = next(iter(sd.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name in sorted(sd):
            t = sd[name]
            if t.dim() >= 2:
                std = 1.0 if any(p in UNIT_NORMAL for p in name.split(".")) else 0.02
                t.copy_(torch.randn(t.shape, generator=gen, device=device) * std)
            elif name.endswith("bias"):
                t.zero_()
            else:
                t.fill_(1.0)
    return sam


def build_sam(sizes: SamSizes, device, seed: int = 0, weights: Optional[str] = None) -> Sam:
    """Float32 SAM on `device`: from the checkpoint `weights`, else random
    from `seed`."""
    with torch.device(device):
        sam = Sam(sizes)
    if weights:
        sd = torch.load(weights, map_location=device, weights_only=True)
        sam.load_state_dict({k: v for k, v in sd.items()
                             if k.split(".")[0] in ("image_encoder", "prompt_encoder",
                                                    "mask_decoder")})
    else:
        init_random(sam, seed)
    return sam.eval().requires_grad_(False)
