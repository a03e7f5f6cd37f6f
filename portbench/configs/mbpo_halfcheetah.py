"""HalfCheetah's termination predicate (``no_termination``): never."""
import torch


def terminated(next_obs: torch.Tensor) -> torch.Tensor:
    return torch.zeros(next_obs.shape[0], dtype=torch.bool, device=next_obs.device)
