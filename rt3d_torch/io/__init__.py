"""Frame IO for the PyTorch port (numpy only): the FrameSource interface,
the .rts recorded-sequence format and its replay (C++ mmap replayer or
NumPy memmap), and the synthetic scene source."""

from rt3d_torch.io.format import SequenceSpec, read_header, write_sequence  # noqa: F401
from rt3d_torch.io.source import FramePacket, FrameSource, ReplaySource  # noqa: F401
from rt3d_torch.io.synthetic import SyntheticSource  # noqa: F401
