"""Pixel observations of a ``gymnasium`` MuJoCo environment (counterpart of
``mbrl_tpu/envs/mujoco_pixel_wrapper.py``): the wrapped environment's frames as
uint8 images (CHW or HWC), action repeat, optional bit-depth quantisation with
dithering noise, optional action normalisation to [-1, 1], and the last
low-dimensional observation (``get_last_low_dim_obs``).

The dithering noise comes from the wrapper's own ``np.random.Generator``,
seeded by ``reset(seed=...)`` (the JAX package draws it from numpy's global
one). Making a wrapper imports ``gymnasium``
(:mod:`mbrl_tpu_torch.envs.gym_classes`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mbrl_tpu_torch.envs.gym_classes import GymClass, box


def _wrapper_base():
    import gymnasium as gym

    return (gym.Wrapper,)


def _quantize(obs: np.ndarray, bit_depth: int, rng: np.random.Generator) -> np.ndarray:
    ratio = 2 ** (8 - bit_depth)
    quantized = (obs // ratio) * ratio
    return (quantized.astype(np.float64) + ratio * rng.random(obs.shape)).astype(np.uint8)


class MujocoGymPixelWrapper(GymClass):
    _gym_bases = staticmethod(_wrapper_base)

    def __init__(
        self,
        env,
        image_width: int = 84,
        image_height: int = 84,
        frame_skip: int = 1,
        camera_id: int = 0,
        channels_first: bool = True,
        bit_depth: int = 8,
        use_true_actions: bool = False,
    ):
        super().__init__(env)
        self._image_width = image_width
        self._image_height = image_height
        self._channels_first = channels_first
        self._frame_skip = frame_skip
        self._camera_id = camera_id
        self._bit_depth = bit_depth
        self._rng = np.random.default_rng()

        shape = (
            (3, image_height, image_width)
            if channels_first
            else (image_height, image_width, 3)
        )
        self.observation_space = box(0, 255, shape, np.uint8)

        # resize the underlying mujoco renderer to the requested frame size
        unwrapped = env.unwrapped
        if hasattr(unwrapped, "mujoco_renderer"):
            unwrapped.width = image_width
            unwrapped.height = image_height
            unwrapped.mujoco_renderer.width = image_width
            unwrapped.mujoco_renderer.height = image_height

        self._use_true_actions = use_true_actions
        self._true_action_space = env.action_space
        if use_true_actions:
            self.action_space = self._true_action_space
        else:
            self.action_space = box(-1.0, 1.0, self._true_action_space.shape, np.float32)
        self._last_low_dim_obs: Optional[np.ndarray] = None

    def _get_obs(self) -> np.ndarray:
        obs = self.render()
        if self._channels_first:
            obs = np.transpose(obs, (2, 0, 1))
        if self._bit_depth != 8:
            obs = _quantize(obs, self._bit_depth, self._rng)
        return obs

    def _denormalize_action(self, action: np.ndarray) -> np.ndarray:
        action = action.astype(np.float64)
        true_delta = self._true_action_space.high - self._true_action_space.low
        norm_delta = self.action_space.high - self.action_space.low
        action = (action - self.action_space.low) / norm_delta
        return (action * true_delta + self._true_action_space.low).astype(np.float32)

    def step(self, action):
        if not self._use_true_actions:
            action = self._denormalize_action(action)
        total_reward = 0.0
        terminated = truncated = False
        for _ in range(self._frame_skip):
            low_dim_obs, reward, terminated, truncated, _ = self.env.step(action)
            self._last_low_dim_obs = low_dim_obs
            total_reward += reward
            if terminated or truncated:
                break
        return self._get_obs(), total_reward, terminated, truncated, {}

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        low_dim_obs, info = self.env.reset(seed=seed)
        self._last_low_dim_obs = low_dim_obs
        return self._get_obs(), info

    def render(self):
        return self.env.render()

    def get_last_low_dim_obs(self) -> Optional[np.ndarray]:
        return self._last_low_dim_obs
