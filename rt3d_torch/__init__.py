"""rt3d_torch: the PyTorch/CUDA port of rt3d for NVIDIA Hopper.

A package of its own beside the JAX reference `rt3d/`, which it never
imports. The main path is `rt3d_torch.pipeline.step.Pipeline.step` (two
HD720 cameras, YOLO11-seg, ByteTrack, voxel clouds, fusion, subtraction);
its hot geometry ops (and the single-cloud SOR of `geometry.sor`) run as
hand-written CUDA kernels (`rt3d_torch/csrc/`), built by one `nvcc` per
source at first use on a CUDA tensor. Users reach it through the CLIs of
`rt3d_torch.apps` (`record` a sequence, then `two_cam` / `one_cam` on it),
which replay `.rts` recordings (`rt3d_torch.io.ReplaySource`, over the C++
replayer of `native/replayer.cpp`) through `rt3d_torch.runtime`'s
`PipelineDriver` and write the reference's CSV logs; `track_only`,
`viewer` (over the live spool of `rt3d_torch.viz.live`) and `plots` are
the other apps. `rt3d_torch.train` trains the detector, and
`rt3d_torch.parallel` shards the step's cameras and the train step's
parameters over a `torch.distributed` process group. Entry points default
to ``device="cuda"``; CPU tensors take each kernel's plain PyTorch version.
"""
