"""PETS HalfCheetah's model-side functions (counterpart of
``mbrl_tpu/envs/pets_halfcheetah.py``).

Only what planning needs: the observation preprocessing hook used by the
dynamics model (``overrides.obs_process_fn``) and the reward. The MuJoCo
environment itself comes with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch


class HalfCheetahEnv:
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
