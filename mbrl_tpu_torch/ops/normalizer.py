"""Input normalizer state (counterpart of ``mbrl_tpu/ops/normalizer.py``).

Stats stay float32: the JAX package uses float64 only when x64 is enabled,
which is off by default. Stats updates (``update_stats``) come with the
training slice.
"""
from __future__ import annotations

import dataclasses

import torch

from mbrl_tpu_torch.device import DeviceLike


@dataclasses.dataclass
class NormalizerState:
    mean: torch.Tensor  # (1, in_size)
    std: torch.Tensor  # (1, in_size)
    eps: float = 1e-5

    def replace(self, **changes) -> "NormalizerState":
        return dataclasses.replace(self, **changes)


def init_normalizer(in_size: int, device: DeviceLike) -> NormalizerState:
    return NormalizerState(
        mean=torch.zeros((1, in_size), dtype=torch.float32, device=device),
        std=torch.ones((1, in_size), dtype=torch.float32, device=device),
        eps=1e-5,
    )


def normalize(state: NormalizerState, val: torch.Tensor) -> torch.Tensor:
    return (val - state.mean) / state.std


def denormalize(state: NormalizerState, val: torch.Tensor) -> torch.Tensor:
    return state.std * val + state.mean
