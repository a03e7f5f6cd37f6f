"""PETS-benchmark 3-D Reacher (counterpart of ``mbrl_tpu/envs/pets_reacher.py``):
a 7-DOF arm reaching a random 3-D goal; 19-dim observation (the full qpos with
the goal's slot, and the arm's qvel), reward = minus the squared distance from
the end effector to the goal minus an action cost, and the analytic forward
kinematics ``get_EE_pos`` used by the environment's reward and by model-side
rewards. Built on the pusher arm, as the reference is; ``get_EE_pos`` is
numpy only, and making an environment imports ``gymnasium`` and ``mujoco``
(:mod:`mbrl_tpu_torch.envs.gym_classes`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mbrl_tpu_torch.envs.gym_classes import GymClass, box, gym_asset, mujoco_bases


class Reacher3DEnv(GymClass):
    metadata = {
        "render_modes": ["human", "rgb_array", "depth_array"],
        "render_fps": 50,
    }
    _gym_bases = staticmethod(mujoco_bases)

    def __init__(self, render_mode: Optional[str] = None):
        from gymnasium import utils
        from gymnasium.envs.mujoco import mujoco_env

        utils.EzPickle.__init__(self)
        self.goal = np.zeros(3)
        observation_space = box(-np.inf, np.inf, (19,), np.float64)
        mujoco_env.MujocoEnv.__init__(
            self, gym_asset("pusher.xml"), 2, observation_space, render_mode
        )

    def step(self, a):
        self.do_simulation(a, self.frame_skip)
        ob = self._get_obs()
        reward = -float(np.sum(np.square(self.get_EE_pos(ob[None]) - self.goal)))
        reward -= 0.01 * float(np.square(a).sum())
        if self.render_mode == "human":
            self.render()
        return ob, reward, False, False, {}

    def reset_model(self):
        qpos, qvel = np.copy(self.init_qpos), np.copy(self.init_qvel)
        qpos[-3:] += self.np_random.normal(loc=0, scale=0.1, size=[3])
        qvel[-3:] = 0
        self.goal = qpos[-3:]
        self.set_state(qpos, qvel)
        return self._get_obs()

    def _get_obs(self):
        return np.concatenate([self.data.qpos.flat, self.data.qvel.flat[:-3]])

    @staticmethod
    def get_EE_pos(states: np.ndarray) -> np.ndarray:
        """Analytic forward kinematics of the arm's end effector from its joint
        angles: states (B, >=7) -> (B, 3). Link lengths of the PR2-style arm
        (shoulder offset 0.1/0.188, upper arm 0.4, forearm 0.321, gripper 0.16828)."""
        t1 = states[:, 0:1]
        t2 = states[:, 1:2]
        t3 = states[:, 2:3]
        t4 = states[:, 3:4]
        t5 = states[:, 4:5]
        t6 = states[:, 5:6]

        rot_axis = np.concatenate(
            [np.cos(t2) * np.cos(t1), np.cos(t2) * np.sin(t1), -np.sin(t2)], axis=1
        )
        rot_perp_axis = np.concatenate(
            [-np.sin(t1), np.cos(t1), np.zeros_like(t1)], axis=1
        )
        cur_end = np.concatenate(
            [
                0.1 * np.cos(t1) + 0.4 * np.cos(t1) * np.cos(t2),
                0.1 * np.sin(t1) + 0.4 * np.sin(t1) * np.cos(t2) - 0.188,
                -0.4 * np.sin(t2),
            ],
            axis=1,
        )

        for length, hinge, roll in ((0.321, t4, t3), (0.16828, t6, t5)):
            perp_all = np.cross(rot_axis, rot_perp_axis)
            x = np.cos(hinge) * rot_axis
            y = np.sin(hinge) * np.sin(roll) * rot_perp_axis
            z = -np.sin(hinge) * np.cos(roll) * perp_all
            new_rot_axis = x + y + z
            new_perp = np.cross(new_rot_axis, rot_axis)
            degenerate = np.linalg.norm(new_perp, axis=1) < 1e-30
            new_perp[degenerate] = rot_perp_axis[degenerate]
            new_perp /= np.linalg.norm(new_perp, axis=1, keepdims=True)
            rot_axis, rot_perp_axis = new_rot_axis, new_perp
            cur_end = cur_end + length * new_rot_axis
        return cur_end
