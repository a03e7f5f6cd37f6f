"""Ensemble layers for custom models (counterpart of ``mbrl_tpu/models/layers.py``):
``ensemble_linear_init`` makes the stacked (E, in, out) weights,
``ensemble_linear`` applies every member in one batched product. Plain
PyTorch: the JAX version is an einsum outside any Pallas kernel."""
from __future__ import annotations

from typing import Dict

import torch

from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.ops.math import truncated_normal_init


def ensemble_linear_init(
    generator: torch.Generator, ensemble_size: int, in_size: int, out_size: int,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    """Stacked member weights, PETS truncated-normal init, zero bias."""
    return {
        "w": truncated_normal_init(
            generator, (ensemble_size, in_size, out_size), fan_in=in_size, device=device
        ),
        "b": torch.zeros((ensemble_size, 1, out_size), device=device),
    }


def ensemble_linear(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Every member in one batched product: x (E, B, in), or (B, in) broadcast
    to every member, -> (E, B, out)."""
    w = params["w"]
    if x.ndim == 2:
        x = x.expand((w.shape[0],) + tuple(x.shape))
    return torch.baddbmm(params["b"], x.float(), w.float())
