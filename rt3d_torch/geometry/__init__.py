"""rt3d_torch.geometry (PyTorch port of rt3d.geometry)."""
