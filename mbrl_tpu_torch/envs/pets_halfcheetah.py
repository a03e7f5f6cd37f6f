"""PETS-variant HalfCheetah (counterpart of ``mbrl_tpu/envs/pets_halfcheetah.py``):
an 18-dim observation whose first entry is the forward velocity from the qpos
difference, reward = velocity - 0.1*||a||^2 (the static ``get_reward``), and
the sin/cos angle preprocessing hook of the dynamics model (``preprocess_fn``,
wired by ``overrides.obs_process_fn``). Built on ``gymnasium``'s bundled
``half_cheetah.xml``.

The static model-side functions import nothing beyond ``torch`` and numpy;
making an environment imports ``gymnasium`` and ``mujoco``
(:mod:`mbrl_tpu_torch.envs.gym_classes`). The reset noise comes from the
environment's own generator, seeded by ``reset(seed=...)`` (the JAX package
draws it from numpy's global one).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mbrl_tpu_torch.envs.gym_classes import GymClass, box, gym_asset, mujoco_bases


class HalfCheetahEnv(GymClass):
    metadata = {
        "render_modes": ["human", "rgb_array", "depth_array"],
        "render_fps": 20,
    }
    _gym_bases = staticmethod(mujoco_bases)

    def __init__(self, render_mode: Optional[str] = None):
        from gymnasium import utils
        from gymnasium.envs.mujoco import mujoco_env

        self.prev_qpos = None
        observation_space = box(-np.inf, np.inf, (18,), np.float64)
        mujoco_env.MujocoEnv.__init__(
            self, gym_asset("half_cheetah.xml"), 5, observation_space, render_mode
        )
        utils.EzPickle.__init__(self)

    def step(self, action):
        self.prev_qpos = np.copy(self.data.qpos.flat)
        self.do_simulation(action, self.frame_skip)
        ob = self._get_obs()
        reward = HalfCheetahEnv.get_reward(ob, action)
        if self.render_mode == "human":
            self.render()
        return ob, reward, False, False, {}

    def _get_obs(self):
        return np.concatenate(
            [
                (self.data.qpos[:1] - self.prev_qpos[:1]) / self.dt,
                self.data.qpos[1:],
                self.data.qvel,
            ]
        )

    def reset_model(self):
        qpos = self.init_qpos + self.np_random.normal(loc=0, scale=0.001, size=self.model.nq)
        qvel = self.init_qvel + self.np_random.normal(loc=0, scale=0.001, size=self.model.nv)
        self.set_state(qpos, qvel)
        self.prev_qpos = np.copy(self.data.qpos)
        return self._get_obs()

    @staticmethod
    def preprocess_fn(state: torch.Tensor) -> torch.Tensor:
        """obs[1], sin(obs[2]), cos(obs[2]), obs[3:] — any leading batch dims."""
        return torch.cat(
            [
                state[..., 1:2],
                torch.sin(state[..., 2:3]),
                torch.cos(state[..., 2:3]),
                state[..., 3:],
            ],
            dim=-1,
        )

    @staticmethod
    def get_reward(next_ob: np.ndarray, action: np.ndarray):
        """reward = forward velocity - 0.1*||a||^2 (batched or single)."""
        next_ob = np.asarray(next_ob)
        action = np.asarray(action)
        was1d = next_ob.ndim == 1
        if was1d:
            next_ob = np.expand_dims(next_ob, 0)
            action = np.expand_dims(action, 0)
        reward_ctrl = -0.1 * np.square(action).sum(axis=-1)
        reward_run = next_ob[..., 0]
        reward = reward_run + reward_ctrl
        return reward.squeeze() if was1d else reward
