"""Training of YOLO11-seg on the synthetic scenes (port of `rt3d/train/`):
the dense targets (`data`), augmentation (`augment`), the objective
(`loss`), the train step and its optimizer (`step`) and the detection-loop
evaluation (`eval`); `rt3d_torch.apps.train_synth` drives them."""

from rt3d_torch.train.loss import seg_detection_loss  # noqa: F401
from rt3d_torch.train.step import AdamW, TrainState, make_train_step  # noqa: F401
