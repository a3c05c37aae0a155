"""Live viewer CLI (port of `rt3d/apps/viewer.py`): tails a pipeline's spool
directory and displays annotated frames + a rotating 3D cloud view — the
reference's interactive windows (`1cam/rt-tracking.py:157-301`) as a
SEPARATE process, so display never costs the pipeline a microsecond.

Run the producer with `--live SPOOL_DIR` (two_cam/one_cam/track_only),
then:

    python -m rt3d_torch.apps.viewer SPOOL_DIR

With a GUI (cv2 + display): live windows; 'q' quits, 's' snapshots the
current frame + scene to disk (the reference's 's' static-capture key,
`rt-tracking.py:288-301`). Headless: re-renders `viewer_scene.png` (with
matplotlib) with a rotating viewpoint each refresh and prints one status
line per frame; ``--once`` renders the current state once and exits.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from typing import Optional, Sequence


def _gui_available() -> bool:
    # macOS cv2 uses Cocoa and needs no DISPLAY; X11 platforms do
    if os.name != "nt" and sys.platform != "darwin" and not os.environ.get("DISPLAY"):
        return False
    from rt3d_torch.viz.draw import optional_cv2

    return optional_cv2() is not None


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("spool", help="spool directory written by --live")
    p.add_argument("--poll", type=float, default=0.1, help="poll interval, seconds")
    p.add_argument("--max-idle", type=float, default=30.0,
                   help="exit after this many seconds without updates (counted from "
                        "the FIRST update — the producer's start-up doesn't count)")
    p.add_argument("--startup-timeout", type=float, default=900.0,
                   help="exit if NO update ever arrives within this long")
    p.add_argument("--out-dir", default=None,
                   help="where rendered views go (default: the spool dir)")
    p.add_argument("--once", action="store_true",
                   help="render the current state once and exit")
    args = p.parse_args(argv)

    from rt3d_torch.viz.live import ViewerState

    state = ViewerState(args.spool, out_dir=args.out_dir)
    gui = _gui_available()
    started = time.time()
    idle_since = None  # set at the first observed update
    snap = 0
    while True:
        status = state.tick()
        if status is not None:
            idle_since = time.time()
            print(f"frame {status['frame']}  {status.get('fps', 0):.1f} FPS  "
                  f"{status.get('objects', 0)} objects  "
                  f"{status.get('workspace_points', 0)} workspace pts", flush=True)
            if gui:
                # DISPLAY being set doesn't guarantee a working X
                # connection; a broken one raises cv2.error on the first
                # imshow — degrade to the headless path instead of dying
                import cv2

                try:
                    fp = os.path.join(args.spool, "frame.png")
                    sp = os.path.join(state.out_dir, "viewer_scene.png")
                    if os.path.exists(fp):
                        cv2.imshow("rt3d cameras", cv2.imread(fp))
                    if os.path.exists(sp):
                        cv2.imshow("rt3d scene", cv2.imread(sp))
                except cv2.error:
                    print("display unavailable; continuing headless", flush=True)
                    gui = False
        if args.once:
            break
        if gui:
            # the event loop must run EVERY iteration: windows repaint and
            # the q/s keys respond between spool updates, not only on them
            import cv2

            try:
                key = cv2.waitKey(max(int(args.poll * 1000), 1)) & 0xFF
            except cv2.error:
                print("display unavailable; continuing headless", flush=True)
                gui = False
                continue
            if key == ord("q"):  # reference quit key (`2cams.py:165`)
                break
            if key == ord("s"):  # static capture (`rt-tracking.py:288`)
                snap += 1
                for src in (os.path.join(args.spool, "frame.png"),
                            os.path.join(state.out_dir, "viewer_scene.png")):
                    if os.path.exists(src):
                        shutil.copyfile(src, src.replace(".png", f"_snap{snap:03d}.png"))
                print(f"snapshot {snap} saved", flush=True)
        else:
            time.sleep(args.poll)
        now = time.time()
        if idle_since is None:
            if now - started > args.startup_timeout:
                print("no producer appeared; exiting", flush=True)
                break
        elif now - idle_since > args.max_idle:
            print("no updates; exiting", flush=True)
            break
    if gui:
        import cv2

        try:
            cv2.destroyAllWindows()
        except cv2.error:
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
