"""rt3d_torch.viz: scene export (PLY) for the port's apps."""
