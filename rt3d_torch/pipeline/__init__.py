"""rt3d_torch.pipeline (PyTorch port of rt3d.pipeline)."""
