"""Walker2d's termination predicate (mbrl-lib's ``termination_fns.walker2d``):
the torso's height, the first observation, leaves (0.8, 2.0), or its angle,
the second, leaves (-1, 1)."""
import torch


def terminated(next_obs: torch.Tensor) -> torch.Tensor:
    height, angle = next_obs[:, 0], next_obs[:, 1]
    alive = (height > 0.8) & (height < 2.0) & (angle > -1.0) & (angle < 1.0)
    return ~alive
