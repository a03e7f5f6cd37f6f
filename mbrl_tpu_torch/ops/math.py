"""Truncated-normal sampling (counterpart of ``mbrl_tpu/ops/math.py``).

Only what planning and model init need: ``truncated_normal`` and
``truncated_normal_init``. Sampling is one-shot inverse-CDF on ±2σ, as
``jax.random.truncated_normal`` does, with an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math as _pymath
from typing import Optional, Sequence

import torch

from mbrl_tpu_torch.device import DeviceLike, rand

_SQRT2 = _pymath.sqrt(2.0)


def truncated_normal(
    generator: torch.Generator,
    shape: Sequence[int],
    mean: float = 0.0,
    std: float = 1.0,
    device: Optional[DeviceLike] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Normal truncated at ±2 std around ``mean``: u ~ U(erf(-√2), erf(√2)),
    x = √2·erfinv(u), clamped inside (-2, 2) exactly as JAX clamps it."""
    device = generator.device if device is None else device
    lo = _pymath.erf(-2.0 / _SQRT2)
    hi = _pymath.erf(2.0 / _SQRT2)
    u = rand(generator, shape, device) * (hi - lo) + lo
    x = _SQRT2 * torch.erfinv(u)
    bound = torch.tensor(2.0, dtype=torch.float32)
    x = torch.clamp(
        x,
        float(torch.nextafter(-bound, bound)),
        float(torch.nextafter(bound, -bound)),
    )
    return (x * std + mean).to(dtype)


def truncated_normal_init(
    generator: torch.Generator,
    shape: Sequence[int],
    fan_in: Optional[int] = None,
    device: Optional[DeviceLike] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """PETS-style weight init: truncated normal with std = 1/(2*sqrt(fan_in))."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / (2.0 * _pymath.sqrt(float(fan_in)))
    return truncated_normal(generator, shape, mean=0.0, std=std, device=device, dtype=dtype)
