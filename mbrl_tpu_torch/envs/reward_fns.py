"""Batched analytic reward functions (counterpart of ``mbrl_tpu/envs/reward_fns.py``).
All take ``(act, next_obs)`` batches and return ``(B, 1)`` float rewards."""
from __future__ import annotations

import torch

from mbrl_tpu_torch.envs import termination_fns


def cartpole(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    return (~termination_fns.cartpole(act, next_obs)).float()


def cartpole_pets(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    goal_pos = torch.tensor([0.0, 0.6], device=next_obs.device)
    x0 = next_obs[:, :1]
    theta = next_obs[:, 1:2]
    ee_pos = torch.cat([x0 - 0.6 * torch.sin(theta), -0.6 * torch.cos(theta)], dim=1)
    obs_cost = torch.exp(-torch.sum(torch.square(ee_pos - goal_pos), dim=1) / (0.6**2))
    act_cost = -0.01 * torch.sum(torch.square(act), dim=1)
    return (obs_cost + act_cost)[:, None]


def inverted_pendulum(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    return (~termination_fns.inverted_pendulum(act, next_obs)).float()


def halfcheetah(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    reward_ctrl = -0.1 * torch.square(act).sum(dim=1)
    reward_run = next_obs[:, 0]
    return (reward_run + reward_ctrl)[:, None]


def pusher(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    goal_pos = torch.tensor([0.45, -0.05, -0.323], device=next_obs.device)
    to_w, og_w = 0.5, 1.25
    tip_pos, obj_pos = next_obs[:, 14:17], next_obs[:, 17:20]
    tip_obj_dist = torch.abs(tip_pos - obj_pos).sum(dim=1)
    obj_goal_dist = torch.abs(goal_pos - obj_pos).sum(dim=1)
    obs_cost = to_w * tip_obj_dist + og_w * obj_goal_dist
    act_cost = 0.1 * torch.square(act).sum(dim=1)
    return -(obs_cost + act_cost)[:, None]
