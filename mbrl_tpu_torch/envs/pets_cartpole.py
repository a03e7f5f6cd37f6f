"""PETS CartPole's model-side function (counterpart of
``mbrl_tpu/envs/pets_cartpole.py``): the observation preprocessing hook used by
the dynamics model (``overrides.obs_process_fn``). The MuJoCo environment itself
comes with a later slice."""
from __future__ import annotations

import torch


class CartPoleEnv:
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
