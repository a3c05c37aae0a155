"""Host-side visualization, off the hot path (port of `rt3d/viz`; numpy,
with cv2 and matplotlib imported at first use where they are installed).

Covers the reference's L4 observability surface: annotated frames with
per-track labels + FPS overlay (`vision_pipeline_utils.py:357-373`), the
smoothed-FPS plot (`2cam/visualizer_fps.py`) and the per-stage timing bar
chart (`2cam/visualizer_performance.py`), the point-cloud scene export
(the Open3D-viewer analog, `1cam/rt-tracking.py:157-285`, done as PLY dumps
an external viewer can watch) and the live spool a viewer process tails.
"""

from rt3d_torch.viz.cloud import load_ply, save_ply  # noqa: F401
from rt3d_torch.viz.draw import annotate_frame, side_by_side  # noqa: F401
from rt3d_torch.viz.plots import plot_fps, plot_stage_timings  # noqa: F401
