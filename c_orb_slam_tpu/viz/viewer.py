"""Headless viewer loop: the Viewer equivalent.

Reference: src/Viewer.cc — a Pangolin window refreshed at camera fps with
menu toggles (follow camera / show points / show KFs+graph / localization
mode / reset, Viewer.cc:54-169). On headless servers the equivalent is a
report writer: it consumes System state every frame and periodically
emits annotated-frame PNGs, map snapshots and a final HTML index.
"""

from __future__ import annotations

import os

import numpy as np

from c_orb_slam_tpu.viz.frame_drawer import FrameDrawer
from c_orb_slam_tpu.viz.map_drawer import MapDrawer


class Viewer:
    def __init__(
        self,
        system,
        out_dir: str,
        every_n: int = 10,
        map_mode: str = "xz",
        follow_camera: bool = True,
    ):
        self.system = system
        self.out_dir = out_dir
        self.every_n = every_n
        self.map_mode = map_mode
        self.follow_camera = follow_camera
        self.frame_drawer = FrameDrawer(system)
        self.map_drawer = MapDrawer(system)
        self.frame_id = -1
        self._snapshots: list[tuple[str, str]] = []
        os.makedirs(out_dir, exist_ok=True)

    def update(self, image):
        """Call once per tracked frame with the input image (any sensor:
        pass the left/gray image)."""
        self.frame_id += 1
        self.frame_drawer.update(image)
        if self.frame_id % self.every_n:
            return
        self._snapshot()

    def _snapshot(self):
        from PIL import Image

        fid = self.frame_id
        frame_png = f"frame_{fid:06d}.png"
        Image.fromarray(self.frame_drawer.draw_frame()).save(
            os.path.join(self.out_dir, frame_png)
        )
        map_png = f"map_{fid:06d}.png"
        pose = self.system.tracker.last_pose
        self.map_drawer.save(
            os.path.join(self.out_dir, map_png),
            mode=self.map_mode,
            current_pose=pose,
        )
        self._snapshots.append((frame_png, map_png))

    def finish(self):
        """Final snapshot + trajectory plot + HTML index."""
        self._snapshot()
        poses, _ = self.system.frame_poses()
        if len(poses):
            import matplotlib

            matplotlib.use("Agg", force=False)
            import matplotlib.pyplot as plt

            centers = np.stack([-p[:, :3].T @ p[:, 3] for p in poses])
            fig, ax = plt.subplots(figsize=(7, 7))
            ax.plot(centers[:, 0], centers[:, 2], "b-", lw=1)
            ax.set_aspect("equal", adjustable="datalim")
            ax.set_title("estimated trajectory (x-z)")
            fig.savefig(
                os.path.join(self.out_dir, "trajectory.png"),
                dpi=110, bbox_inches="tight",
            )
            plt.close(fig)
        rows = "\n".join(
            f'<tr><td><img src="{f}" width="480"></td>'
            f'<td><img src="{m}" width="400"></td></tr>'
            for f, m in self._snapshots
        )
        html = (
            "<html><body><h2>c_orb_slam_tpu run report</h2>"
            '<img src="trajectory.png" width="500"><table>'
            f"{rows}</table></body></html>"
        )
        with open(os.path.join(self.out_dir, "index.html"), "w") as f:
            f.write(html)
