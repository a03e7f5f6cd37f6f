"""Batched analytic termination predicates (counterpart of
``mbrl_tpu/envs/termination_fns.py``). All take ``(act, next_obs)`` batches
and return ``(B, 1)`` bool."""
from __future__ import annotations

import math

import torch


def hopper(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    height = next_obs[:, 0]
    angle = next_obs[:, 1]
    not_done = (
        torch.isfinite(next_obs).all(-1)
        & (torch.abs(next_obs[:, 1:]) < 100).all(-1)
        & (height > 0.7)
        & (torch.abs(angle) < 0.2)
    )
    return (~not_done)[:, None]


def cartpole(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    x, theta = next_obs[:, 0], next_obs[:, 2]
    x_threshold = 2.4
    theta_threshold = 12 * 2 * math.pi / 360
    not_done = (
        (x > -x_threshold)
        & (x < x_threshold)
        & (theta > -theta_threshold)
        & (theta < theta_threshold)
    )
    return (~not_done)[:, None]


def inverted_pendulum(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    not_done = torch.isfinite(next_obs).all(-1) & (torch.abs(next_obs[:, 1]) <= 0.2)
    return (~not_done)[:, None]


def no_termination(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    return torch.zeros((next_obs.shape[0], 1), dtype=torch.bool, device=next_obs.device)


def walker2d(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    height = next_obs[:, 0]
    angle = next_obs[:, 1]
    not_done = (height > 0.8) & (height < 2.0) & (angle > -1.0) & (angle < 1.0)
    return (~not_done)[:, None]


def ant(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    x = next_obs[:, 0]
    not_done = torch.isfinite(next_obs).all(-1) & (x >= 0.2) & (x <= 1.0)
    return (~not_done)[:, None]


def humanoid(act: torch.Tensor, next_obs: torch.Tensor) -> torch.Tensor:
    z = next_obs[:, 0]
    return ((z < 1.0) | (z > 2.0))[:, None]
