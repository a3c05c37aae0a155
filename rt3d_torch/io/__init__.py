"""Frame IO for the PyTorch port: the frame container and the synthetic
scene source (numpy-only)."""

from rt3d_torch.io.source import FramePacket  # noqa: F401
from rt3d_torch.io.synthetic import SyntheticSource  # noqa: F401
