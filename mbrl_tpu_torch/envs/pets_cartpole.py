"""PETS-paper cartpole swing-up on MuJoCo (counterpart of
``mbrl_tpu/envs/pets_cartpole.py``): 4-dim (qpos, qvel) observation,
exponential end-effector reward toward the upright position minus an action
cost, and the sin/cos angle preprocessing hook (``preprocess_fn``; it widens
the observation, so configs set the model's ``in_size`` by hand).

``preprocess_fn`` imports nothing beyond ``torch``; making an environment
imports ``gymnasium`` and ``mujoco`` (:mod:`mbrl_tpu_torch.envs.gym_classes`).
The reset noise comes from the environment's own generator, seeded by
``reset(seed=...)`` (the JAX package draws it from numpy's global one).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from mbrl_tpu_torch.envs.gym_classes import GymClass, box, mujoco_bases

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "cartpole_swingup.xml")


class CartPoleEnv(GymClass):
    PENDULUM_LENGTH = 0.6
    metadata = {
        "render_modes": ["human", "rgb_array", "depth_array"],
        "render_fps": 25,
    }
    _gym_bases = staticmethod(mujoco_bases)

    def __init__(self, render_mode: Optional[str] = None):
        from gymnasium import utils
        from gymnasium.envs.mujoco import mujoco_env

        utils.EzPickle.__init__(self)
        observation_space = box(-np.inf, np.inf, (4,), np.float64)
        mujoco_env.MujocoEnv.__init__(self, _ASSET, 2, observation_space, render_mode)

    def step(self, a):
        self.do_simulation(a, self.frame_skip)
        ob = self._get_obs()
        ee = CartPoleEnv._get_ee_pos(ob)
        reward = np.exp(
            -np.sum(np.square(ee - np.array([0.0, CartPoleEnv.PENDULUM_LENGTH])))
            / (CartPoleEnv.PENDULUM_LENGTH**2)
        )
        reward -= 0.01 * np.sum(np.square(a))
        if self.render_mode == "human":
            self.render()
        return ob, reward, False, False, {}

    def reset_model(self):
        qpos = self.init_qpos + self.np_random.normal(0, 0.1, np.shape(self.init_qpos))
        qvel = self.init_qvel + self.np_random.normal(0, 0.1, np.shape(self.init_qvel))
        self.set_state(qpos, qvel)
        return self._get_obs()

    def _get_obs(self):
        return np.concatenate([self.data.qpos, self.data.qvel]).ravel()

    @staticmethod
    def _get_ee_pos(x):
        x0, theta = x[0], x[1]
        return np.array(
            [
                x0 - CartPoleEnv.PENDULUM_LENGTH * np.sin(theta),
                -CartPoleEnv.PENDULUM_LENGTH * np.cos(theta),
            ]
        )

    @staticmethod
    def preprocess_fn(state: torch.Tensor) -> torch.Tensor:
        """[sin(theta), cos(theta), x, qvel...] — any leading batch dims."""
        return torch.cat(
            [
                torch.sin(state[..., 1:2]),
                torch.cos(state[..., 1:2]),
                state[..., :1],
                state[..., 2:],
            ],
            dim=-1,
        )
