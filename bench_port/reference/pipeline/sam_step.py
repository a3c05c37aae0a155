"""The plain reference pipeline with Segment Anything as its mask model:
the frozen YOLO11-seg pipeline of `step.py`, SAM's encoder run in `detect`
on every camera's frame (its embeddings are the mask context), and SAM's
mask stage in place of the proto masks, in float32.

The mask stage: each camera's box slots, valid or not, scaled to the
encoder's input (`apply_boxes_torch`), prompt SAM with
``multimask_output=False``; mask 0's logits go through `postprocess_masks`
and ``> 0``, and are then cut to the slot's box and validity, the crop the
proto path's retina masks take (SAM's predictor does not cut).

`ModelConfig` is the frozen model config with the fields that choose the
mask model, for the stated configuration."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from bench_port.reference import config
from bench_port.reference.geometry.image import erode_mask
from bench_port.reference.models.sam import Sam
from bench_port.reference.pipeline.step import Pipeline


@dataclass(frozen=True)
class ModelConfig(config.ModelConfig):
    mask_model: str = "proto"
    sam_weights: Optional[str] = None
    sam_seed: int = 0


class SamImages(NamedTuple):
    yolo: torch.Tensor  # the detector's letterboxed input
    sam: torch.Tensor   # SAM's input (C, 3, S, S)


@dataclass
class SamPipeline(Pipeline):
    sam: Optional[Sam] = None

    def _src_hw(self):
        cam = self.cfg.rig.cameras[0].intrinsics
        return cam.height, cam.width

    def preprocess(self, rgb: torch.Tensor) -> SamImages:
        return SamImages(super().preprocess(rgb), self.sam.preprocess(rgb))

    def detect(self, images: SamImages):
        """(detections, SAM's embeddings (C, 256, h, w), ReID embeddings)."""
        det, _, emb = super().detect(images.yolo)
        return det, self.sam.image_encoder(images.sam), emb

    def track(self, state, det, det_emb=None, images=None):
        return super().track(state, det, det_emb=det_emb,
                             images=None if images is None else images.yolo)

    def low_res_logits(self, embeddings: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """(C, D, 4h, 4w) mask 0's logits of each camera's (D, 4) boxes in
        original pixels."""
        return torch.stack([
            self.sam.low_res_logits(embeddings[c:c + 1],
                                    self.sam.apply_boxes(boxes[c], self._src_hw()))[:, 0]
            for c in range(boxes.shape[0])])

    def masks(self, embeddings: torch.Tensor, det) -> torch.Tensor:
        src_hw = self._src_hw()
        input_hw = self.sam.get_preprocess_shape(*src_hw)
        low = self.low_res_logits(embeddings, det.boxes)
        out = []
        for c in range(low.shape[0]):
            m = self.sam.postprocess_masks(low[c][:, None], input_hw, src_hw)[:, 0] > 0.0
            ys = torch.arange(src_hw[0], dtype=torch.float32, device=m.device)[:, None]
            xs = torch.arange(src_hw[1], dtype=torch.float32, device=m.device)[None, :]
            x1, y1, x2, y2 = (det.boxes[c][:, i][:, None, None] for i in range(4))
            inbox = (xs[None] >= x1) & (xs[None] < x2) & (ys[None] >= y1) & (ys[None] < y2)
            out.append(m & inbox & det.valid[c][:, None, None])
        out = torch.stack(out)
        k = self.cfg.pipeline.erode_kernel
        return erode_mask(out, k) if k > 0 else out
