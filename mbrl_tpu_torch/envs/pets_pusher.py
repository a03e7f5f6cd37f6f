"""PETS-benchmark Pusher (counterpart of ``mbrl_tpu/envs/pets_pusher.py``): a
7-DOF PR2-style arm pushing a cylinder to a goal; 20-dim observation (arm qpos
and qvel, tips_arm and object positions, the goal left out), reward
``1.25*dist + 0.1*ctrl + 0.5*near`` computed before the step, frame skip 4, a
fixed goal and a little cylinder-position noise on reset. Built on
``gymnasium``'s bundled ``pusher.xml``; making an environment imports
``gymnasium`` and ``mujoco`` (:mod:`mbrl_tpu_torch.envs.gym_classes`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mbrl_tpu_torch.envs.gym_classes import GymClass, box, gym_asset, mujoco_bases


class PusherEnv(GymClass):
    metadata = {
        "render_modes": ["human", "rgb_array", "depth_array"],
        "render_fps": 25,
    }
    _gym_bases = staticmethod(mujoco_bases)

    def __init__(self, render_mode: Optional[str] = None):
        from gymnasium import utils
        from gymnasium.envs.mujoco import mujoco_env

        observation_space = box(-np.inf, np.inf, (20,), np.float64)
        mujoco_env.MujocoEnv.__init__(
            self, gym_asset("pusher.xml"), 4, observation_space, render_mode
        )
        utils.EzPickle.__init__(self)
        self.reset_model()

    def step(self, a):
        obj_pos = self.get_body_com("object")
        vec_to_arm = obj_pos - self.get_body_com("tips_arm")
        vec_to_goal = obj_pos - self.get_body_com("goal")
        reward_near = -np.sum(np.abs(vec_to_arm))
        reward_dist = -np.sum(np.abs(vec_to_goal))
        reward_ctrl = -np.square(a).sum()
        reward = 1.25 * reward_dist + 0.1 * reward_ctrl + 0.5 * reward_near

        self.do_simulation(a, self.frame_skip)
        ob = self._get_obs()
        if self.render_mode == "human":
            self.render()
        return ob, reward, False, False, {}

    def reset_model(self):
        qpos = np.copy(self.init_qpos)
        self.goal_pos = np.asarray([0.0, 0.0])
        self.cylinder_pos = np.array([-0.25, 0.15]) + self.np_random.normal(0, 0.025, [2])
        qpos[-4:-2] = self.cylinder_pos
        qpos[-2:] = self.goal_pos
        qvel = self.init_qvel + self.np_random.uniform(
            low=-0.005, high=0.005, size=self.model.nv
        )
        qvel[-4:] = 0
        self.set_state(qpos, qvel)
        self.ac_goal_pos = self.get_body_com("goal")
        return self._get_obs()

    def _get_obs(self):
        return np.concatenate(
            [
                self.data.qpos.flat[:7],
                self.data.qvel.flat[:7],
                self.get_body_com("tips_arm"),
                self.get_body_com("object"),
            ]
        )
