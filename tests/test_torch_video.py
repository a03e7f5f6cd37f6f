"""The port's ``VideoRecorder`` (``mbrl_tpu_torch/util/video.py``) against
mbrl_tpu's, and ``mbpo.train(save_video=True)``, on the CPU.

The frames are compared exactly: both packages store what the environment
renders, and with ``imageio`` unimportable both write them to ``.npz``.
"""
import sys

import numpy as np

import mbrl_tpu_torch.algorithms.mbpo as mbpo
from mbrl_tpu.util.video import VideoRecorder as JaxVideoRecorder
from mbrl_tpu_torch.util.video import VideoRecorder
from test_torch_mbpo import _mock_term_fn, _small_cfg
from test_torch_pets import _TRIAL_LEN, MockLineEnv


class RenderingLineEnv(MockLineEnv):
    """MockLineEnv with an 8x16 RGB frame: a bar at the point's position."""

    def render(self):
        frame = np.zeros((8, 16, 3), np.uint8)
        col = int(np.clip((self.pos + 2.0) * 4.0, 0, 15))
        frame[:, col] = (255, 128, int(self.time_left) * 20 % 256)
        return frame


def _record(recorder_cls, root, actions):
    env = RenderingLineEnv()
    rec = recorder_cls(root, fps=10)
    env.reset()
    rec.init(enabled=True)
    for a in actions:
        env.step(np.array([a]))
        rec.record(env)
    rec.save("episode.mp4")
    return rec


def test_frames_equal_jax_with_imageio_blocked(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)  # `import imageio` raises
    actions = np.random.default_rng(0).uniform(-0.3, 0.3, 7)
    rec = _record(VideoRecorder, tmp_path / "port", actions)
    jrec = _record(JaxVideoRecorder, tmp_path / "jax", actions)
    assert len(rec.frames) == 7
    frames = np.load(tmp_path / "port" / "video" / "episode.mp4.npz")["frames"]
    jframes = np.load(tmp_path / "jax" / "video" / "episode.mp4.npz")["frames"]
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(frames, np.stack(jrec.frames))
    assert not (tmp_path / "port" / "video" / "episode.mp4").exists()


def test_disabled_and_unrendering_recorders_write_nothing(tmp_path):
    rec = VideoRecorder(None)
    rec.init(enabled=True)
    assert not rec.enabled

    class NoRender(MockLineEnv):
        def render(self):
            raise NotImplementedError

    rec = VideoRecorder(tmp_path)
    rec.init(enabled=True)
    rec.record(NoRender())
    assert not rec.enabled
    rec.save("x.mp4")
    assert not any((tmp_path / "video").iterdir())


def test_mbpo_save_video_writes_each_epoch(tmp_path, monkeypatch):
    """``save_video=True``: each epoch's first evaluation episode, one file
    an epoch (``.mp4.npz`` here: imageio is blocked)."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    cfg = _small_cfg()
    cfg["save_video"] = True
    recorded = []
    evaluate = mbpo.evaluate

    def spy(env, agent, num_episodes, video_recorder=None):
        out = evaluate(env, agent, num_episodes, video_recorder=video_recorder)
        recorded.append(len(video_recorder.frames))
        return out

    monkeypatch.setattr(mbpo, "evaluate", spy)
    best = mbpo.train(RenderingLineEnv(), RenderingLineEnv(), _mock_term_fn, cfg, silent=True,
                      work_dir=str(tmp_path), device="cpu")
    assert np.isfinite(best)
    epochs = cfg.overrides.num_steps // cfg.overrides.epoch_length
    assert recorded == [_TRIAL_LEN] * epochs
    names = sorted(p.name for p in (tmp_path / "video").iterdir())
    assert names == [f"{e}.mp4.npz" for e in range(epochs)]
    frames = np.load(tmp_path / "video" / "0.mp4.npz")["frames"]
    assert frames.shape == (_TRIAL_LEN, 8, 16, 3) and frames.dtype == np.uint8
