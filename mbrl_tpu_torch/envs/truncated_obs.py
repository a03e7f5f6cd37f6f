"""MBPO-paper truncated-observation Ant and Humanoid (counterpart of
``mbrl_tpu/envs/truncated_obs.py``): ``gymnasium``'s MuJoCo Ant and Humanoid
physics and rewards, with the external contact forces (and Humanoid's
cinert, cvel and actuator forces) left out of the observation. Making an
environment imports ``gymnasium`` and ``mujoco``
(:mod:`mbrl_tpu_torch.envs.gym_classes`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mbrl_tpu_torch.envs.gym_classes import GymClass, box, mujoco_bases


class AntTruncatedObsEnv(GymClass):
    metadata = {
        "render_modes": ["human", "rgb_array", "depth_array"],
        "render_fps": 20,
    }
    _gym_bases = staticmethod(mujoco_bases)

    def __init__(self, render_mode: Optional[str] = None):
        from gymnasium import utils
        from gymnasium.envs.mujoco import mujoco_env

        observation_space = box(-np.inf, np.inf, (27,), np.float64)
        mujoco_env.MujocoEnv.__init__(
            self, "ant.xml", 5, observation_space, render_mode=render_mode
        )
        utils.EzPickle.__init__(self)

    def step(self, a):
        xposbefore = self.get_body_com("torso")[0]
        self.do_simulation(a, self.frame_skip)
        xposafter = self.get_body_com("torso")[0]
        forward_reward = (xposafter - xposbefore) / self.dt
        ctrl_cost = 0.5 * np.square(a).sum()
        contact_cost = 0.5 * 1e-3 * np.sum(np.square(np.clip(self.data.cfrc_ext, -1, 1)))
        survive_reward = 1.0
        reward = forward_reward - ctrl_cost - contact_cost + survive_reward
        state = self.state_vector()
        alive = np.isfinite(state).all() and 0.2 <= state[2] <= 1.0
        if self.render_mode == "human":
            self.render()
        return self._get_obs(), reward, not alive, False, {}

    def _get_obs(self):
        # contact forces left out (the MBPO paper's truncation)
        return np.concatenate([self.data.qpos.flat[2:], self.data.qvel.flat])

    def reset_model(self):
        qpos = self.init_qpos + self.np_random.uniform(
            size=self.model.nq, low=-0.1, high=0.1
        )
        qvel = self.init_qvel + self.np_random.standard_normal(self.model.nv) * 0.1
        self.set_state(qpos, qvel)
        return self._get_obs()


def _mass_center(model, data):
    mass = np.expand_dims(model.body_mass, axis=1)
    xpos = data.xipos
    return (np.sum(mass * xpos, axis=0) / np.sum(mass))[0]


class HumanoidTruncatedObsEnv(GymClass):
    metadata = {
        "render_modes": ["human", "rgb_array", "depth_array"],
        "render_fps": 67,
    }
    _gym_bases = staticmethod(mujoco_bases)

    def __init__(self, render_mode: Optional[str] = None):
        from gymnasium import utils
        from gymnasium.envs.mujoco import mujoco_env

        observation_space = box(-np.inf, np.inf, (45,), np.float64)
        mujoco_env.MujocoEnv.__init__(
            self, "humanoid.xml", 5, observation_space, render_mode=render_mode
        )
        utils.EzPickle.__init__(self)

    def _get_obs(self):
        # cinert, cvel, actuator and contact channels left out (the MBPO paper's truncation)
        return np.concatenate([self.data.qpos.flat[2:], self.data.qvel.flat])

    def step(self, a):
        pos_before = _mass_center(self.model, self.data)
        self.do_simulation(a, self.frame_skip)
        pos_after = _mass_center(self.model, self.data)
        alive_bonus = 5.0
        lin_vel_cost = 0.25 * (pos_after - pos_before) / self.model.opt.timestep
        quad_ctrl_cost = 0.1 * np.square(self.data.ctrl).sum()
        quad_impact_cost = min(0.5e-6 * np.square(self.data.cfrc_ext).sum(), 10)
        reward = lin_vel_cost - quad_ctrl_cost - quad_impact_cost + alive_bonus
        z = self.data.qpos[2]
        terminated = bool(z < 1.0 or z > 2.0)
        if self.render_mode == "human":
            self.render()
        return self._get_obs(), reward, terminated, False, {}

    def reset_model(self):
        c = 0.01
        self.set_state(
            self.init_qpos + self.np_random.uniform(low=-c, high=c, size=self.model.nq),
            self.init_qvel + self.np_random.uniform(low=-c, high=c, size=self.model.nv),
        )
        return self._get_obs()
