"""Headless MuJoCo video rendering for deploy-side visualisation.

The reference uses the interactive `mujoco.viewer` window
(reference mujoco_infer.py:105-154, ref_motion_viewer.py:67-86); on a
headless machine the equivalent is offscreen EGL rendering to an animated
GIF (PIL) or MP4 (OpenCV) — the same scenes, camera-tracked on the duck.

Import of this module does not require a GL context, ``mujoco``, PIL or
OpenCV: ``mujoco`` is imported when a renderer is made, the GL context on
the first frame, PIL or OpenCV when the video is saved.
"""

from __future__ import annotations

import os

import numpy as np


class MjVideoRenderer:
    """Offscreen renderer over a MuJoCo model; collects frames, writes video.

    Usage:
        r = MjVideoRenderer(xml_path, fps=25)
        for qpos in trajectory:
            r.add_qpos_frame(qpos)       # kinematic playback
        # or, with a live MjData: r.add_frame(data)
        r.save("rollout.gif")
    """

    def __init__(self, model_or_xml, width: int = 480, height: int = 360,
                 fps: float = 25.0, camera: str | None = None,
                 track_body: str = "trunk_assembly"):
        os.environ.setdefault("MUJOCO_GL", "egl")
        import mujoco

        self._mujoco = mujoco
        if isinstance(model_or_xml, str):
            self.model = mujoco.MjModel.from_xml_path(model_or_xml)
        else:
            self.model = model_or_xml
        self.data = mujoco.MjData(self.model)
        self.width, self.height, self.fps = width, height, fps
        self.frames: list[np.ndarray] = []
        self._renderer = None
        self._cam = mujoco.MjvCamera()
        mujoco.mjv_defaultCamera(self._cam)
        if camera is not None:
            self._cam.fixedcamid = mujoco.mj_name2id(
                self.model, mujoco.mjtObj.mjOBJ_CAMERA, camera
            )
            self._cam.type = mujoco.mjtCamera.mjCAMERA_FIXED
        else:
            # free camera tracking the robot trunk from a 3/4 view
            self._cam.distance = 0.9
            self._cam.elevation = -20.0
            self._cam.azimuth = 135.0
            self._track = mujoco.mj_name2id(
                self.model, mujoco.mjtObj.mjOBJ_BODY, track_body
            )

    def _ensure_renderer(self):
        if self._renderer is None:
            # mujoco binds its GL platform from $MUJOCO_GL at import time;
            # when mujoco was already imported headless (e.g. by the
            # inference engine), make an EGL context current explicitly.
            try:
                from mujoco.egl import GLContext

                self._gl = GLContext(self.width, self.height)
                self._gl.make_current()
            except Exception:
                pass  # a context may already exist (MUJOCO_GL was set)
            self._renderer = self._mujoco.Renderer(
                self.model, self.height, self.width
            )
        return self._renderer

    def add_qpos_frame(self, qpos) -> None:
        self.data.qpos[:] = np.asarray(qpos, float)
        self._mujoco.mj_forward(self.model, self.data)
        self.add_frame(self.data)

    def add_frame(self, data) -> None:
        r = self._ensure_renderer()
        if getattr(self, "_track", -1) >= 0 and self._cam.type != \
                self._mujoco.mjtCamera.mjCAMERA_FIXED:
            self._cam.lookat[:] = data.xpos[self._track]
        r.update_scene(data, camera=self._cam)
        self.frames.append(r.render().copy())

    def save(self, path: str) -> str:
        if not self.frames:
            raise ValueError("no frames captured")
        if path.endswith(".gif"):
            from PIL import Image

            imgs = [Image.fromarray(f) for f in self.frames]
            imgs[0].save(
                path, save_all=True, append_images=imgs[1:],
                duration=int(1000 / self.fps), loop=0,
            )
        elif path.endswith(".mp4"):
            import cv2

            h, w = self.frames[0].shape[:2]
            vw = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h)
            )
            if not vw.isOpened():
                raise RuntimeError("cv2 VideoWriter failed to open; use .gif")
            for f in self.frames:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            vw.release()
        else:
            raise ValueError(f"unsupported extension: {path} (use .gif/.mp4)")
        print(f"wrote {path} ({len(self.frames)} frames @ {self.fps} fps)")
        return path
