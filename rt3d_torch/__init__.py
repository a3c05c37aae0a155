"""rt3d_torch: the PyTorch/CUDA port of rt3d for NVIDIA Hopper.

A package of its own beside the JAX reference `rt3d/`, which it never
imports. The main path is `rt3d_torch.pipeline.step.Pipeline.step` (two
HD720 cameras, YOLO11-seg, ByteTrack, voxel clouds, fusion, subtraction);
its four hot geometry ops run as hand-written CUDA kernels
(`rt3d_torch/csrc/`), built by one `nvcc` call at first use on a CUDA
tensor. Entry points default to ``device="cuda"``; CPU tensors take each
kernel's plain PyTorch version.
"""
