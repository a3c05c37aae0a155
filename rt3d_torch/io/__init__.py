"""Frame IO for the PyTorch port (numpy only): the FrameSource interface,
the .rts recorded-sequence format and its replay (C++ mmap replayer or
NumPy memmap), the synthetic scene source, and live capture through a
callback or the ZED SDK (`rt3d_torch.io.live`)."""

from rt3d_torch.io.format import SequenceSpec, read_header, write_sequence  # noqa: F401
from rt3d_torch.io.source import FramePacket, FrameSource, ReplaySource  # noqa: F401
from rt3d_torch.io.synthetic import SyntheticSource  # noqa: F401
from rt3d_torch.io.live import CallbackSource, zed_sdk_source  # noqa: F401
