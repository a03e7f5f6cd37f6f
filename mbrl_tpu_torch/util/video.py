"""Video recording of environment rollouts (counterpart of
``mbrl_tpu/util/video.py``; host only, no device).

Capability parity with the reference's vendored ``pytorch_sac`` VideoRecorder
(third_party/pytorch_sac/video.py:8-40): init/record/save API, enabled flag, frames
captured via env render, saved as mp4 (falls back to .npz of frames when no video
backend is available). ``imageio`` is imported only when a video is saved.
"""
from __future__ import annotations

import pathlib

import numpy as np


class VideoRecorder:
    def __init__(self, root_dir, height: int = 256, width: int = 256, fps: int = 30):
        self.save_dir = pathlib.Path(root_dir) / "video" if root_dir else None
        if self.save_dir is not None:
            self.save_dir.mkdir(parents=True, exist_ok=True)
        self.height = height
        self.width = width
        self.fps = fps
        self.frames: list = []
        self.enabled = False

    def init(self, enabled: bool = True) -> None:
        self.frames = []
        self.enabled = self.save_dir is not None and enabled

    def record(self, env) -> None:
        if not self.enabled:
            return
        try:
            frame = env.render()
        except NotImplementedError:
            self.enabled = False  # env cannot render; disable quietly
            return
        if frame is not None:
            self.frames.append(np.asarray(frame))

    def save(self, file_name: str) -> None:
        if not (self.enabled and self.frames):
            return
        path = self.save_dir / file_name
        try:
            import imageio

            imageio.mimsave(str(path), self.frames, fps=self.fps)
        except Exception:
            np.savez_compressed(str(path) + ".npz", frames=np.stack(self.frames))
