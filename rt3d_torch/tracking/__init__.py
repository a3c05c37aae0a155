"""rt3d_torch.tracking (PyTorch port of rt3d.tracking)."""
