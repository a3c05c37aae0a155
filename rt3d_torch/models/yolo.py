"""YOLO11-seg as PyTorch modules (port of `rt3d/models/yolo/core.py` and
`model.py`).

The module tree mirrors the JAX package's parameter paths, which mirror the
ultralytics module names: the JAX leaf ``10/m/0/attn/qkv/conv/kernel`` is
the parameter ``10.m.0.attn.qkv.conv.weight`` here. BatchNorm is folded
into every conv (inference form), as in the JAX package's weights.

Public layouts are the JAX package's: images go in as (B, H, W, 3), box,
class and mask-coefficient logits come out as (B, A, C) over anchors in
row-major order per level, prototypes as (B, H/4, W/4, nm). Inside, tensors
are NCHW in channels-last memory, the layout cuDNN runs fastest.

Convolutions run in the model's parameter dtype (bf16 on the card via
`cast_for_inference`, f32 in the CPU tests), with the bias added and the
SiLU applied in that dtype after the convolution, as `core.conv2d` does.
Attention scores and their product with the values accumulate in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

SCALES: Dict[str, Tuple[float, float, int]] = {  # depth, width, max channels
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}
STRIDES = (8, 16, 32)
REG_MAX = 16


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Conv(nn.Module):
    """A bare convolution with bias (a JAX ``…/{kernel,bias}`` leaf)."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.pad, self.groups = s, k // 2, groups

    def forward(self, x: torch.Tensor, act: bool = False) -> torch.Tensor:
        y = F.conv2d(x, self.weight, None, self.stride, self.pad, 1, self.groups)
        y = y + self.bias[:, None, None]
        return silu(y) if act else y


class ConvModule(nn.Module):
    """Ultralytics `Conv`: conv + folded BN (+ SiLU); path ``<name>/conv``."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv(cin, cout, k, s, groups)
        self.act = act

    def forward(self, x):
        return self.conv(x, self.act)


def dw_conv(cin: int, cout: int, k: int = 3) -> ConvModule:
    """Ultralytics `DWConv`: groups = gcd(cin, cout)."""
    return ConvModule(cin, cout, k, groups=math.gcd(cin, cout))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool, e: float = 0.5):
        super().__init__()
        hidden = int(c * e)
        self.cv1 = ConvModule(c, hidden, 3)
        self.cv2 = ConvModule(hidden, c, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3k(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 2, shortcut: bool = True):
        super().__init__()
        c_ = int(cout * 0.5)
        self.cv1 = ConvModule(cin, c_)
        self.cv2 = ConvModule(cin, c_)
        self.m = nn.Sequential(*[Bottleneck(c_, shortcut, e=1.0) for _ in range(n)])
        self.cv3 = ConvModule(2 * c_, cout)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class C3k2(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, use_c3k: bool,
                 e: float = 0.5, shortcut: bool = True):
        super().__init__()
        c = int(cout * e)
        self.c = c
        self.cv1 = ConvModule(cin, 2 * c)
        self.m = nn.ModuleList([
            C3k(c, c, 2, shortcut) if use_c3k else Bottleneck(c, shortcut, 0.5)
            for _ in range(n)])
        self.cv2 = ConvModule((2 + n) * c, cout)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for block in self.m:
            parts.append(block(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 5):
        super().__init__()
        c_ = cin // 2
        self.cv1 = ConvModule(cin, c_)
        self.cv2 = ConvModule(4 * c_, cout)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, dim=1))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.nh = num_heads
        self.hd = dim // num_heads
        self.kd = int(self.hd * attn_ratio)
        self.scale = self.kd ** -0.5
        self.qkv = ConvModule(dim, dim + 2 * self.kd * num_heads, act=False)
        self.pe = ConvModule(dim, dim, 3, groups=dim, act=False)
        self.proj = ConvModule(dim, dim, act=False)

    def forward(self, x):
        b, dim, h, w = x.shape
        qkv = self.qkv(x).reshape(b, self.nh, 2 * self.kd + self.hd, h * w)
        q, k, v = qkv.split([self.kd, self.kd, self.hd], dim=2)
        attn = torch.matmul(q.float().transpose(-1, -2), k.float()) * self.scale
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(v.float(), attn.float().transpose(-1, -2)).to(x.dtype)
        out = out.reshape(b, dim, h, w)
        pe = self.pe(v.reshape(b, dim, h, w))
        return self.proj(out + pe)


class PSABlock(nn.Module):
    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn = nn.Sequential(ConvModule(c, 2 * c), ConvModule(2 * c, c, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c1: int, n: int):
        super().__init__()
        c = int(c1 * 0.5)
        self.c = c
        self.cv1 = ConvModule(c1, 2 * c)
        self.m = nn.Sequential(*[PSABlock(c, c // 64) for _ in range(n)])
        self.cv2 = ConvModule(2 * c, c1)

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, :self.c], y[:, self.c:]
        return self.cv2(torch.cat([a, self.m(b)], dim=1))


class ConvTranspose2x(nn.Module):
    """ConvTranspose2d(k=2, s=2) (`core.conv_transpose2x`): weight IOHW,
    bias added after, in the parameter dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, None, stride=2) + self.bias[:, None, None]


class Proto(nn.Module):
    def __init__(self, cin: int, c_: int, cout: int):
        super().__init__()
        self.cv1 = ConvModule(cin, c_, 3)
        self.upsample = ConvTranspose2x(c_, c_)
        self.cv2 = ConvModule(c_, c_, 3)
        self.cv3 = ConvModule(c_, cout)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class HeadBranch(nn.Module):
    """One level of a Detect/Segment branch: two blocks then a bare conv,
    with children named "0", "1", "2" like ultralytics' Sequential."""

    def __init__(self, b0: nn.Module, b1: nn.Module, out: Conv):
        super().__init__()
        self.add_module("0", b0)
        self.add_module("1", b1)
        self.add_module("2", out)

    def forward(self, x):
        return getattr(self, "2")(getattr(self, "1")(getattr(self, "0")(x)))


class SegmentHead(nn.Module):
    """Ultralytics `Segment` (layer 23): prototype head plus per-level box
    (cv2), class (cv3) and mask-coefficient (cv4) branches."""

    def __init__(self, ch: Tuple[int, int, int], nc: int, nm: int, npr: int):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        c4 = max(ch[0] // 4, nm)
        self.nc, self.nm = nc, nm
        self.proto = Proto(ch[0], npr, nm)
        self.cv2 = nn.ModuleList([
            HeadBranch(ConvModule(c, c2, 3), ConvModule(c2, c2, 3), Conv(c2, 4 * REG_MAX))
            for c in ch])
        self.cv3 = nn.ModuleList([
            HeadBranch(nn.Sequential(dw_conv(c, c), ConvModule(c, c3)),
                       nn.Sequential(dw_conv(c3, c3), ConvModule(c3, c3)),
                       Conv(c3, nc))
            for c in ch])
        self.cv4 = nn.ModuleList([
            HeadBranch(ConvModule(c, c4, 3), ConvModule(c4, c4, 3), Conv(c4, nm))
            for c in ch])

    def forward(self, feats):
        def flat(t):
            b, c = t.shape[:2]
            return t.permute(0, 2, 3, 1).reshape(b, -1, c).float()

        protos = self.proto(feats[0])
        boxes = torch.cat([flat(br(f)) for br, f in zip(self.cv2, feats)], dim=1)
        clss = torch.cat([flat(br(f)) for br, f in zip(self.cv3, feats)], dim=1)
        coeffs = torch.cat([flat(br(f)) for br, f in zip(self.cv4, feats)], dim=1)
        return boxes, clss, coeffs, protos.permute(0, 2, 3, 1).float()


class YoloSeg(nn.Module):
    """YOLO11-seg at one of the ultralytics scales (n/s/m/l/x)."""

    def __init__(self, variant: str = "x", num_classes: int = 80,
                 num_mask_coeffs: int = 32,
                 input_hw: Tuple[int, int] = (384, 640)):
        super().__init__()
        self.variant = variant
        self.num_classes = num_classes
        self.num_mask_coeffs = num_mask_coeffs
        self.input_hw = tuple(input_hw)
        depth, _, _ = SCALES[variant]
        w = self._w

        def d(n):
            return max(round(n * depth), 1)

        mlx = variant in ("m", "l", "x")
        layers = {
            "0": ConvModule(3, w(64), 3, 2),
            "1": ConvModule(w(64), w(128), 3, 2),
            "2": C3k2(w(128), w(256), d(2), mlx, e=0.25),
            "3": ConvModule(w(256), w(256), 3, 2),
            "4": C3k2(w(256), w(512), d(2), mlx, e=0.25),
            "5": ConvModule(w(512), w(512), 3, 2),
            "6": C3k2(w(512), w(512), d(2), True, e=0.5),
            "7": ConvModule(w(512), w(1024), 3, 2),
            "8": C3k2(w(1024), w(1024), d(2), True, e=0.5),
            "9": SPPF(w(1024), w(1024)),
            "10": C2PSA(w(1024), d(2)),
            "13": C3k2(w(1024) + w(512), w(512), d(2), mlx, e=0.5),
            "16": C3k2(w(512) + w(512), w(256), d(2), mlx, e=0.5),
            "17": ConvModule(w(256), w(256), 3, 2),
            "19": C3k2(w(256) + w(512), w(512), d(2), mlx, e=0.5),
            "20": ConvModule(w(512), w(512), 3, 2),
            "22": C3k2(w(512) + w(1024), w(1024), d(2), True, e=0.5),
            "23": SegmentHead(self.level_channels, num_classes,
                              num_mask_coeffs, w(256)),
        }
        for name, mod in layers.items():
            self.add_module(name, mod)

    def _w(self, c: int) -> int:
        _, width, max_ch = SCALES[self.variant]
        return make_divisible(min(c, max_ch) * width, 8)

    @property
    def level_channels(self) -> Tuple[int, int, int]:
        return (self._w(256), self._w(512), self._w(1024))

    def _layer(self, name: str) -> nn.Module:
        return getattr(self, name)

    def backbone_neck(self, x):
        L = self._layer
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        x = L("2")(L("1")(L("0")(x)))
        p3 = L("4")(L("3")(x))
        p4 = L("6")(L("5")(p3))
        p5 = L("10")(L("9")(L("8")(L("7")(p4))))
        h13 = L("13")(torch.cat([up(p5), p4], dim=1))
        h16 = L("16")(torch.cat([up(h13), p3], dim=1))
        h19 = L("19")(torch.cat([L("17")(h16), h13], dim=1))
        h22 = L("22")(torch.cat([L("20")(h19), p5], dim=1))
        return h16, h19, h22

    def forward_with_feats(self, images: torch.Tensor):
        """images (B, H, W, 3) in [0, 1]. Returns ((box_logits (B, A, 64),
        cls_logits (B, A, nc), mask_coeffs (B, A, nm), protos
        (B, H/4, W/4, nm)), neck features (NCHW))."""
        dtype = self._layer("0").conv.weight.dtype
        x = images.to(dtype).permute(0, 3, 1, 2)
        feats = self.backbone_neck(x)
        return self._layer("23")(feats), feats

    def forward(self, images):
        return self.forward_with_feats(images)[0]


def state_dict_from_npz(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX package's flat weights (``np.load("weights/yolo11?_synth_seg.npz")``:
    HWIO conv kernels with BN folded, the proto ConvTranspose as
    ``…/upsample/kernel`` in (kh, kw, I, O)) as this module tree's
    state_dict (OIHW convs, IOHW ConvTranspose, float32). In memory only."""
    sd = {}
    for key, arr in flat.items():
        path, leaf = key.rsplit("/", 1)
        a = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            a = a.transpose(2, 3, 0, 1) if path.endswith("upsample") else a.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unexpected weight {key!r}")
        sd[f"{path.replace('/', '.')}.{leaf}"] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def load_weights(model: YoloSeg, path: str) -> YoloSeg:
    """Load a JAX-package ``.npz`` weight file into `model` (strict)."""
    with np.load(path) as z:
        sd = state_dict_from_npz({k: z[k] for k in z.files})
    model.load_state_dict(sd, strict=True)
    return model


def init_random(model: YoloSeg, seed: int) -> YoloSeg:
    """Uniform fan-in init of every conv weight, zero biases, from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.endswith("bias"):
                p.zero_()
            else:
                fan_in = (p.shape[0] if "upsample" in name  # IOHW: fan-in = I
                          else int(np.prod(p.shape[1:])))
                bound = 1.0 / math.sqrt(max(fan_in, 1))
                p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
    return model


def cast_for_inference(model: YoloSeg, dtype: torch.dtype,
                       device: torch.device | str) -> YoloSeg:
    """Counterpart of `core.cast_params_for_inference`: every parameter in
    the compute dtype once, at load time, channels-last, on `device`."""
    return model.to(device=device, dtype=dtype,
                    memory_format=torch.channels_last).eval().requires_grad_(False)
