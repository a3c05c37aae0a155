"""The plain reference of the benchmark: a frozen copy of the plain PyTorch
path of the port's step (config, YOLO11-seg, decode and NMS, the trackers,
masks, voxel dedupe, fusion with SOR, subtraction, accumulation). Every
kernel takes its plain version (`kernels.use_kernel` is always False), and
it imports nothing of the program, of the JAX package or of JAX. It runs in
float32 with TF32 off."""
