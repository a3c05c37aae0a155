"""The work of one YOLO11-seg forward, counted from the published model
definition and never from the program.

`LAYERS` is Ultralytics' `ultralytics/cfg/models/11/yolo11-seg.yaml` layer
table (from, repeats, module, args). A scale (depth multiple, width
multiple, max channels) sizes it as Ultralytics' `parse_model` does:
channels `ceil(min(c, max) * width / 8) * 8`, repeats `max(round(n *
depth), 1)`, and the C3k2 blocks of the m, l and x scales take C3k
inner blocks. The count is 2 x the multiply-accumulates of every
convolution (depthwise ones included) and of the Segment head's proto
path, whose 2x upsample is a transposed convolution. The attention
matmuls of C2PSA and every elementwise op are not counted (Ultralytics'
published GFLOPs leave them out too).
"""

from __future__ import annotations

import math
from typing import List, Tuple

SCALES = {  # depth multiple, width multiple, max channels
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

# Ultralytics' published GFLOPs at 640 x 640 (80 classes), for comparison
PUBLISHED_GFLOPS_640 = {"n": 10.4, "s": 35.5, "m": 123.3, "l": 142.2, "x": 319.0}

REG_MAX = 16

LAYERS = [
    (-1, 1, "Conv", [64, 3, 2]),            # 0 P1/2
    (-1, 1, "Conv", [128, 3, 2]),           # 1 P2/4
    (-1, 2, "C3k2", [256, False, 0.25]),    # 2
    (-1, 1, "Conv", [256, 3, 2]),           # 3 P3/8
    (-1, 2, "C3k2", [512, False, 0.25]),    # 4
    (-1, 1, "Conv", [512, 3, 2]),           # 5 P4/16
    (-1, 2, "C3k2", [512, True]),           # 6
    (-1, 1, "Conv", [1024, 3, 2]),          # 7 P5/32
    (-1, 2, "C3k2", [1024, True]),          # 8
    (-1, 1, "SPPF", [1024, 5]),             # 9
    (-1, 2, "C2PSA", [1024]),               # 10
    (-1, 1, "Upsample", [None, 2, "nearest"]),  # 11
    ([-1, 6], 1, "Concat", [1]),            # 12
    (-1, 2, "C3k2", [512, False]),          # 13
    (-1, 1, "Upsample", [None, 2, "nearest"]),  # 14
    ([-1, 4], 1, "Concat", [1]),            # 15
    (-1, 2, "C3k2", [256, False]),          # 16 P3/8
    (-1, 1, "Conv", [256, 3, 2]),           # 17
    ([-1, 13], 1, "Concat", [1]),           # 18
    (-1, 2, "C3k2", [512, False]),          # 19 P4/16
    (-1, 1, "Conv", [512, 3, 2]),           # 20
    ([-1, 10], 1, "Concat", [1]),           # 21
    (-1, 2, "C3k2", [1024, True]),          # 22 P5/32
    ([16, 19, 22], 1, "Segment", ["nc", 32, 256]),  # 23
]


def conv_macs(h: int, w: int, cin: int, cout: int, k: int = 1, s: int = 1,
              groups: int = 1) -> Tuple[int, int, int]:
    """(multiply-accumulates, output height, output width) of a k x k conv
    with padding k // 2."""
    ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
    return ho * wo * cout * (cin // groups) * k * k, ho, wo


class _Counter:
    def __init__(self):
        self.macs = 0

    def conv(self, h, w, cin, cout, k=1, s=1, groups=1):
        m, ho, wo = conv_macs(h, w, cin, cout, k, s, groups)
        self.macs += m
        return ho, wo

    def bottleneck(self, h, w, c, e):
        hidden = int(c * e)
        self.conv(h, w, c, hidden, 3)
        self.conv(h, w, hidden, c, 3)

    def c3k(self, h, w, cin, cout, n=2):
        c_ = int(cout * 0.5)
        self.conv(h, w, cin, c_)
        self.conv(h, w, cin, c_)
        for _ in range(n):
            self.bottleneck(h, w, c_, 1.0)
        self.conv(h, w, 2 * c_, cout)

    def c3k2(self, h, w, cin, cout, n, c3k, e):
        c = int(cout * e)
        self.conv(h, w, cin, 2 * c)
        for _ in range(n):
            if c3k:
                self.c3k(h, w, c, c, 2)
            else:
                self.bottleneck(h, w, c, 0.5)
        self.conv(h, w, (2 + n) * c, cout)

    def sppf(self, h, w, cin, cout):
        c_ = cin // 2
        self.conv(h, w, cin, c_)
        self.conv(h, w, 4 * c_, cout)

    def c2psa(self, h, w, c1, n):
        c = int(c1 * 0.5)
        self.conv(h, w, c1, 2 * c)
        heads = c // 64
        kd = int(c // heads * 0.5)
        for _ in range(n):
            self.conv(h, w, c, c + 2 * kd * heads)   # qkv
            self.conv(h, w, c, c, 3, groups=c)       # positional encoding, depthwise
            self.conv(h, w, c, c)                    # proj
            self.conv(h, w, c, 2 * c)                # ffn
            self.conv(h, w, 2 * c, c)
        self.conv(h, w, 2 * c, c1)

    def segment(self, levels, nc, nm, npr):
        (h0, w0, c0) = levels[0]
        c2 = max(16, c0 // 4, REG_MAX * 4)
        c3 = max(c0, min(nc, 100))
        c4 = max(c0 // 4, nm)
        # proto: 3x3 conv, 2x transposed conv (k 2, s 2), 3x3 conv, 1x1 conv
        self.conv(h0, w0, c0, npr, 3)
        h1, w1 = 2 * h0, 2 * w0
        self.macs += h1 * w1 * npr * npr  # each output pixel: one tap per input channel
        self.conv(h1, w1, npr, npr, 3)
        self.conv(h1, w1, npr, nm)
        for h, w, c in levels:
            self.conv(h, w, c, c2, 3)                # box branch
            self.conv(h, w, c2, c2, 3)
            self.conv(h, w, c2, 4 * REG_MAX)
            self.conv(h, w, c, c, 3, groups=c)       # class branch
            self.conv(h, w, c, c3)
            self.conv(h, w, c3, c3, 3, groups=c3)
            self.conv(h, w, c3, c3)
            self.conv(h, w, c3, nc)
            self.conv(h, w, c, c4, 3)                # mask-coefficient branch
            self.conv(h, w, c4, c4, 3)
            self.conv(h, w, c4, nm)


def yolo11_seg_flops(variant: str, input_hw: Tuple[int, int], num_classes: int = 80) -> int:
    """FLOPs (2 x multiply-accumulates) of one image's forward."""
    depth, width, max_ch = SCALES[variant]
    mlx = variant in ("m", "l", "x")

    def ch(c):
        return int(math.ceil(min(c, max_ch) * width / 8) * 8)

    cnt = _Counter()
    outs: List[Tuple[int, int, int]] = []  # (h, w, channels) of each layer
    h, w = input_hw
    c = 3
    for i, (frm, reps, mod, args) in enumerate(LAYERS):
        n = max(round(reps * depth), 1) if reps > 1 else reps
        if isinstance(frm, list):
            srcs = [outs[j] if j >= 0 else outs[i + j] for j in frm]
        else:
            srcs = [outs[i + frm] if outs else (h, w, c)]
        sh, sw, sc = srcs[0]
        if mod == "Conv":
            ho, wo = cnt.conv(sh, sw, sc, ch(args[0]), args[1], args[2])
            outs.append((ho, wo, ch(args[0])))
        elif mod == "C3k2":
            cout = ch(args[0])
            c3k = bool(args[1]) or mlx
            e = args[2] if len(args) > 2 else 0.5
            cnt.c3k2(sh, sw, sc, cout, n, c3k, e)
            outs.append((sh, sw, cout))
        elif mod == "SPPF":
            cnt.sppf(sh, sw, sc, ch(args[0]))
            outs.append((sh, sw, ch(args[0])))
        elif mod == "C2PSA":
            cnt.c2psa(sh, sw, sc, n)
            outs.append((sh, sw, sc))
        elif mod == "Upsample":
            outs.append((sh * 2, sw * 2, sc))
        elif mod == "Concat":
            outs.append((sh, sw, sum(s[2] for s in srcs)))
        elif mod == "Segment":
            cnt.segment(srcs, num_classes, args[1], ch(args[2]))
            outs.append((0, 0, 0))
        else:
            raise ValueError(f"unknown module {mod}")
    return 2 * cnt.macs
