"""dm_control suite tasks behind the port's environment API, pixel or state
observations (counterpart of ``mbrl_tpu/util/dmcontrol_wrapper.py``).

Domain and task construction, the action spec as a :class:`Box`, frame skip
(action repeat), pixel rendering at a configurable height, width and camera,
and bit-depth reduction of pixel observations. ``reset`` and ``step`` return
what a ``gymnasium`` environment returns, but nothing here needs
``gymnasium``, and ``dm_control`` is imported only when an environment is made.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mbrl_tpu_torch.envs.spaces import Box
from mbrl_tpu_torch.envs.time_limit import TimeLimit


def _flatten_spec(spec) -> np.ndarray:
    return np.concatenate([np.asarray(s).ravel() for s in spec])


class DmControlEnv:
    """A dm_control suite task with ``reset``, ``step``, ``render`` and the two
    spaces."""

    def __init__(
        self,
        domain_name: str,
        task_name: str,
        task_kwargs: Optional[dict] = None,
        visualize_reward: bool = False,
        from_pixels: bool = False,
        height: int = 84,
        width: int = 84,
        camera_id: int = 0,
        frame_skip: int = 1,
        bit_depth: int = 8,
        channels_first: bool = True,
        seed: Optional[int] = None,
    ):
        from dm_control import suite

        task_kwargs = dict(task_kwargs or {})
        if seed is not None:
            task_kwargs.setdefault("random", seed)
        self._env = suite.load(
            domain_name=domain_name,
            task_name=task_name,
            task_kwargs=task_kwargs,
            visualize_reward=visualize_reward,
        )
        self._from_pixels = from_pixels
        self._height = height
        self._width = width
        self._camera_id = camera_id
        self._frame_skip = frame_skip
        self._bit_depth = bit_depth
        self._channels_first = channels_first

        act_spec = self._env.action_spec()
        self.action_space = Box(
            act_spec.minimum.astype(np.float32), act_spec.maximum.astype(np.float32),
            dtype=np.float32,
        )
        if from_pixels:
            shape = (3, height, width) if channels_first else (height, width, 3)
            self.observation_space = Box(0, 255, shape=shape, dtype=np.uint8)
        else:
            obs_spec = self._env.observation_spec()
            dim = int(sum(np.prod(s.shape) if s.shape else 1 for s in obs_spec.values()))
            self.observation_space = Box(-np.inf, np.inf, shape=(dim,), dtype=np.float64)

    # ------------------------------------------------------------------ #
    def _get_obs(self, time_step) -> np.ndarray:
        if self._from_pixels:
            img = self.render()
            if self._bit_depth < 8:
                ratio = 2 ** (8 - self._bit_depth)
                img = (img // ratio) * ratio
            if self._channels_first:
                img = img.transpose(2, 0, 1)
            return img
        return _flatten_spec(list(time_step.observation.values()))

    def reset(self, *, seed: Optional[int] = None, options=None):
        time_step = self._env.reset()
        return self._get_obs(time_step), {}

    def step(self, action: np.ndarray):
        action = np.clip(action, self.action_space.low, self.action_space.high).astype(np.float64)
        reward = 0.0
        terminated = False
        time_step = None
        for _ in range(self._frame_skip):
            time_step = self._env.step(action)
            reward += time_step.reward or 0.0
            terminated = time_step.last()
            if terminated:
                break
        obs = self._get_obs(time_step)
        # dm_control episodes end by time limit -> truncation, not termination
        discount_zero = time_step.discount == 0.0
        return obs, reward, bool(terminated and discount_zero), bool(
            terminated and not discount_zero
        ), {}

    def render(self):
        return self._env.physics.render(
            height=self._height, width=self._width, camera_id=self._camera_id
        )


def make(
    domain_name: str,
    task_name: str,
    seed: Optional[int] = None,
    visualize_reward: bool = False,
    from_pixels: bool = False,
    height: int = 84,
    width: int = 84,
    camera_id: int = 0,
    frame_skip: int = 1,
    bit_depth: int = 8,
    episode_length: Optional[int] = None,
):
    """dmc2gym-compatible constructor; ``episode_length`` caps every episode
    (:class:`~mbrl_tpu_torch.envs.time_limit.TimeLimit`)."""
    env = DmControlEnv(
        domain_name,
        task_name,
        visualize_reward=visualize_reward,
        from_pixels=from_pixels,
        height=height,
        width=width,
        camera_id=camera_id,
        frame_skip=frame_skip,
        bit_depth=bit_depth,
        seed=seed,
    )
    if episode_length is not None:
        env = TimeLimit(env, max_episode_steps=episode_length)
    return env
