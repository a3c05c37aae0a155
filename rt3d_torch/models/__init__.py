"""rt3d_torch.models (PyTorch port of rt3d.models)."""
