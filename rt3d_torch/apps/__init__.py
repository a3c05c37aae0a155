"""CLI entry points of the port, the analogs of the reference's L2 scripts
(each `main(argv=None)` returns 0):

  python -m rt3d_torch.apps.two_cam         ~ 2cam/2cams.py / 2cams_mask_gpu.py
  python -m rt3d_torch.apps.one_cam         ~ 1cam/rt-tracking.py
  python -m rt3d_torch.apps.record          ~ (new) sequence recorder
  python -m rt3d_torch.apps.convert_weights ~ the ultralytics .pt load

`track_only`, `viewer` and `plots` are ROADMAP item 15.
"""
