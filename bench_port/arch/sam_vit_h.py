"""Segment Anything, ViT-H (Kirillov et al., arXiv:2304.02643;
`build_sam.py`'s `build_sam_vit_h`) as the mask model: YOLO11-seg's boxes
prompt SAM on the same frame (Ultralytics' `auto_annotate(det_model,
sam_model)`), SAM's masks in place of the proto masks.

The configuration file states the YOLO11-seg fields that
`arch/yolo11_seg.py` reads, the program's `model` overrides that pick SAM
(`mask_model`, `sam_seed`), and SAM's sizes in full (`sam`). The stated
config adds the mask-model fields to the frozen model config
(`bench_port/reference/pipeline/sam_step.py`). The plain reference is the
frozen YOLO11-seg pipeline with SAM's float32 encoder in `detect` and SAM's
mask stage in place of the proto masks. The control rounds every Linear
weight of SAM's encoder through float8 e4m3 with one scale an output
channel (weights-only FP8), YOLO left in bf16.

FLOPs count a multiply-add as two, matrix products only (softmax, norms and
the bias add are not counted), from the published definition:

* encoder, per image: the patch embedding; in each windowed block qkv and
  proj on the padded grid (ceil(g / w) windows a side, w^2 tokens each),
  q k^T and a v within each window, the relative position terms
  (2 x hd x (k_h + k_w) a query and head), the MLP on the g^2 tokens; in
  each global block the same over all g^2 tokens; the neck;
* decoder, per prompt: the two-way transformer (7 tokens: the IoU token, 4
  mask tokens, 2 box corners; keys and values of the image computed again
  for every prompt, as the image embedding is repeated), the upscaling, the
  4 hypernetwork MLPs, the masks' product and the IoU head.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

from bench_port import spec

YOLO = spec.architecture("yolo11_seg")

# the published ViT-H sizes (`build_sam_vit_h`, `_build_sam`), under the
# names of the configuration file's `sam` block
VIT_H = dict(image_size=1024, patch_size=16, embed_dim=1280, depth=32, num_heads=16,
             mlp_dim=5120, window_size=14, global_attn_indexes=[7, 15, 23, 31],
             prompt_embed_dim=256, decoder_depth=2, decoder_heads=8, decoder_mlp_dim=2048,
             attention_downsample_rate=2, num_multimask_outputs=3, iou_head_depth=3,
             iou_head_hidden_dim=256, mask_in_chans=16, layer_norm_eps=1e-6)
SAM_FIELDS = ("mask_model", "sam_weights", "sam_seed")
# relative L2 distance of a valid slot's low-resolution logits from the
# reference's beyond which the slot counts as off: about twice the median
# of the program in bf16
SAM_OFF = 0.036
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def encoder_flops(s) -> int:
    """One image through the encoder, of sizes `s` (the `sam` block)."""
    g, c, w = s["image_size"] // s["patch_size"], s["embed_dim"], s["window_size"]
    t = g * g
    wins = math.ceil(g / w) ** 2
    total = 2 * t * c * 3 * s["patch_size"] ** 2
    for i in range(s["depth"]):
        if i in s["global_attn_indexes"]:
            lin, attn, k = t, 4 * t * t * c, 2 * g
        else:
            lin, attn, k = wins * w * w, 4 * wins * (w * w) ** 2 * c, 2 * w
        total += 2 * lin * c * 4 * c + attn + 2 * lin * c * k + 4 * t * c * s["mlp_dim"]
    d = s["prompt_embed_dim"]
    return total + 2 * t * c * d + 2 * t * d * d * 9


def decoder_flops(s) -> int:
    """One box prompt through the mask decoder."""
    g, d = s["image_size"] // s["patch_size"], s["prompt_embed_dim"]
    img, r, masks = g * g, d // s["attention_downsample_rate"], s["num_multimask_outputs"] + 1
    tok = 1 + masks + 2

    def cross(nq, nk):  # q from nq tokens, k and v from nk, at width r
        return 2 * nq * d * r + 4 * nk * d * r + 4 * nq * nk * r + 2 * nq * r * d

    block = (8 * tok * d * d + 4 * tok * tok * d) + cross(tok, img) \
        + 4 * tok * d * s["decoder_mlp_dim"] + cross(img, tok)
    up = 2 * img * d * d + 2 * (4 * img) * (d // 4) * (d // 8) * 4
    hyper = masks * 2 * (d * d + d * d + d * d // 8) + 2 * 16 * img * (d // 8) * masks
    h = s["iou_head_hidden_dim"]
    iou = 2 * (d * h + h * h * (s["iou_head_depth"] - 2) + h * masks)
    return s["decoder_depth"] * block + cross(tok, img) + up + hyper + iou


def encoder_weight_bytes(s, itemsize: int = 2) -> int:
    """The encoder's parameters, read once a batch."""
    g, c, d, p = s["image_size"] // s["patch_size"], s["embed_dim"], s["prompt_embed_dim"], \
        s["patch_size"]
    hd = c // s["num_heads"]
    n = c * 3 * p * p + c + g * g * c + c * d + d * d * 9 + 4 * d
    for i in range(s["depth"]):
        k = g if i in s["global_attn_indexes"] else s["window_size"]
        n += 4 * c + 3 * c * c + 3 * c + c * c + c + 2 * (2 * k - 1) * hd \
            + 2 * c * s["mlp_dim"] + s["mlp_dim"] + c
    return n * itemsize


def encoder_activation_bytes(s, itemsize: int = 2) -> int:
    """One image's least traffic: its input read, each block's residual
    stream read and written once, the embedding written."""
    g, c = s["image_size"] // s["patch_size"], s["embed_dim"]
    return itemsize * (3 * s["image_size"] ** 2 + 2 * s["depth"] * g * g * c
                       + s["prompt_embed_dim"] * g * g)


def _max_detections(conf) -> int:
    from bench_port.reference import config as rconfig

    return conf.get("model", {}).get("max_detections",
                                     getattr(rconfig, conf["base"])().model.max_detections)


def flops_per_image(conf) -> int:
    """One camera image: YOLO11-seg's forward, SAM's encoder, and the
    decoder once for each of the `max_detections` box slots."""
    s = conf["sam"]
    return YOLO.flops_per_image(conf) + encoder_flops(s) + decoder_flops(s) * _max_detections(conf)


def stated_config(conf, cameras, dtype=None):
    """The configuration the file states: the frozen config classes, their
    model config with the mask-model fields."""
    from bench_port.reference import config as rconfig
    from bench_port.reference.pipeline.sam_step import ModelConfig

    model = dict(conf.get("model", {}))
    own = {k: model.pop(k) for k in SAM_FIELDS if k in model}
    cfg = spec.make_config(rconfig, dict(conf, model=model), cameras, dtype)
    fields = {f.name: getattr(cfg.model, f.name) for f in dataclasses.fields(cfg.model)}
    return dataclasses.replace(cfg, model=ModelConfig(**fields, **own))


def check_program(cfg, conf) -> None:
    """Raise unless the program runs the YOLO11-seg fields the file states
    and its SAM has the file's sizes."""
    from rt3d_torch.models.sam import sam_sizes

    YOLO.check_program(cfg, conf)
    got = dataclasses.asdict(sam_sizes(cfg.model.mask_model))
    got["global_attn_indexes"] = list(got["global_attn_indexes"])
    if got != conf["sam"]:
        differ = sorted(k for k in set(got) | set(conf["sam"]) if got.get(k) != conf["sam"].get(k))
        raise ValueError(f"SAM's sizes {', '.join(differ)} differ from the file's")


def reference_pipeline(conf, cameras, device, weights: str):
    """The float32 reference: the YOLO11-seg reference pipeline with SAM
    (random from the file's `sam_seed` by the program's rule, or its
    `sam_weights`)."""
    from bench_port.reference.models.sam import SamSizes, build_sam
    from bench_port.reference.pipeline.sam_step import SamPipeline
    from bench_port.reference.pipeline.step import build_pipeline

    cfg = stated_config(conf, cameras, dtype="float32")
    yolo = build_pipeline(cfg, weights=weights, device=device)
    sam = build_sam(SamSizes.from_dict(conf["sam"]), device, seed=cfg.model.sam_seed,
                    weights=cfg.model.sam_weights)
    return SamPipeline(cfg=cfg, model=yolo.model, device=yolo.device, sam=sam)


def control(pipe, weights: str, conf, frames) -> None:
    """Weights-only FP8: each Linear weight of SAM's encoder rounded
    through float8 e4m3fn, with one scale an output channel (its largest
    magnitude to 448), and back to the compute dtype."""
    import torch

    with torch.no_grad():
        for mod in pipe.sam.image_encoder.modules():
            if isinstance(mod, torch.nn.Linear):
                w = mod.weight.float()
                scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / FP8_MAX
                q = (w / scale).to(torch.float8_e4m3fn).float() * scale
                mod.weight.copy_(q.to(mod.weight.dtype))


def _global_blocks(pipe):
    sam = pipe.sam
    return [sam.image_encoder.blocks[i] for i in sam.sizes.global_attn_indexes]


def sam_global_windowed(pipe):
    """The global blocks attend in windows of the windowed blocks' size."""
    for blk in _global_blocks(pipe):
        blk.window_size = pipe.sam.sizes.window_size
    return lambda: None


# Dropping the global blocks' relative position terms is no fault here: under
# the random-weight rule (the tables drawn at 0.02) it moves the logits an
# eighth as far as bf16's rounding does, so no limit can tell it; the CPU
# tests catch it in float32.
FAULTS = {f.__name__: f for f in (sam_global_windowed,)}


class ExtraNumbers:
    """The program's published low-resolution logits (`FrameOutputs.
    low_res_logits`) against the reference's, from the reference's own
    float32 embeddings and the program's detections: the relative L2
    distance of each valid slot. `sam_logit_rel_med` is their median,
    `sam_logit_off_share` the share over `SAM_OFF`."""

    def __init__(self):
        self.rel = []

    def add(self, ref, ctx, masks, outputs) -> None:
        import torch

        det = outputs.detections
        low = outputs.low_res_logits
        if low is None:
            raise ValueError("the program published no SAM logits")
        r = ref.low_res_logits(ctx, det.boxes.float())
        for c in range(det.valid.shape[0]):
            for i in torch.nonzero(det.valid[c]).flatten().tolist():
                diff = (low[c, i].float() - r[c, i]).norm()
                self.rel.append(float(diff / r[c, i].norm().clamp_min(1e-12)))

    def numbers(self):
        return dict(sam_logit_rel_med=statistics.median(self.rel) if self.rel else 0.0,
                    sam_logit_off_share=sum(v > SAM_OFF for v in self.rel) / max(len(self.rel), 1))
