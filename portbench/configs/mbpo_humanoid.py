"""Humanoid's termination predicate (mbrl-lib's ``termination_fns.humanoid``):
the torso's height, the first observation, leaves [1, 2]."""
import torch


def terminated(next_obs: torch.Tensor) -> torch.Tensor:
    z = next_obs[:, 0]
    return (z < 1.0) | (z > 2.0)
