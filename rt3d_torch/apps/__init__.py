"""CLI entry points of the port, the analogs of the reference's L2 scripts
(each `main(argv=None)` returns 0):

  python -m rt3d_torch.apps.two_cam         ~ 2cam/2cams.py / 2cams_mask_gpu.py
  python -m rt3d_torch.apps.one_cam         ~ 1cam/rt-tracking.py
  python -m rt3d_torch.apps.track_only      ~ 1cam/yolo11_tracking.py
  python -m rt3d_torch.apps.viewer          ~ the reference's display windows
  python -m rt3d_torch.apps.plots           ~ 2cam/visualizer_{fps,performance}.py
  python -m rt3d_torch.apps.record          ~ (new) sequence recorder
  python -m rt3d_torch.apps.convert_weights ~ the ultralytics .pt load
  python -m rt3d_torch.apps.train_synth     ~ tools/train_synth.py
"""
