"""Core math functions (counterpart of ``mbrl_tpu/ops/math.py``).

Truncated-normal sampling is one-shot inverse-CDF on ±2σ, as
``jax.random.truncated_normal`` does; every draw takes an explicit
``torch.Generator``. ``quantize_obs`` (pixels) comes with the PlaNet slice.
"""
from __future__ import annotations

import math as _pymath
from typing import Iterable, Optional, Sequence, Tuple, Union

import torch

from mbrl_tpu_torch.device import DeviceLike, rand, randint, randn

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


def truncated_linear(min_x: float, max_x: float, min_y: float, max_y: float, x: float) -> float:
    """Truncated linear schedule: min_y at x<=min_x, linear up to max_y at x>=max_x
    (Python floats)."""
    if max_x - min_x < 1e-10:
        return max_y
    if x <= min_x:
        return min_y
    dx = (x - min_x) / (max_x - min_x)
    dx = min(dx, 1.0)
    return dx * (max_y - min_y) + min_y


def gaussian_nll(
    pred_mean: torch.Tensor,
    pred_logvar: torch.Tensor,
    target: torch.Tensor,
    reduce: bool = True,
) -> torch.Tensor:
    """Negative log-likelihood of a diagonal Gaussian (up to constants):
    ``(mean - target)^2 * exp(-logvar) + logvar``. When ``reduce``, summed over
    the last axis, then averaged over the rest."""
    losses = torch.square(pred_mean - target) * torch.exp(-pred_logvar) + pred_logvar
    if reduce:
        return losses.sum(dim=-1).mean()
    return losses


# ------------------------------------------------------------------------ #
# Uncertainty propagation (PETS trajectory-sampling variants)
# ------------------------------------------------------------------------ #
def propagate_from_indices(predicted: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Select ``out[i] = predicted[indices[i], i]`` from an ``E x B x Od`` stack."""
    idx = indices.reshape(1, -1, 1).expand(1, predicted.shape[1], predicted.shape[2])
    return torch.gather(predicted, 0, idx.long())[0]


def propagate_random_model(
    generator: torch.Generator, predictions: Tuple[torch.Tensor, ...]
) -> Tuple[torch.Tensor, ...]:
    """TS1: a uniformly random member per batch row (fresh per prediction)."""
    out = []
    for p in predictions:
        indices = randint(generator, 0, p.shape[0], (p.shape[1],), p.device)
        out.append(propagate_from_indices(p, indices))
    return tuple(out)


def propagate_expectation(predictions: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Mean over ensemble members."""
    return tuple(p.mean(dim=0) for p in predictions)


def propagate_fixed_model(
    predictions: Tuple[torch.Tensor, ...], propagation_indices: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """TSinf: persistent per-row member indices for every prediction."""
    return tuple(propagate_from_indices(p, propagation_indices) for p in predictions)


def propagate(
    predictions: Tuple[torch.Tensor, ...],
    propagation_method: str = "expectation",
    propagation_indices: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, ...]:
    """Dispatch over the three PETS propagation modes."""
    if propagation_method == "random_model":
        if generator is None:
            raise ValueError("propagate(random_model) requires a generator")
        return propagate_random_model(generator, predictions)
    if propagation_method == "fixed_model":
        if propagation_indices is None:
            raise ValueError("propagate(fixed_model) requires propagation_indices")
        return propagate_fixed_model(predictions, propagation_indices)
    if propagation_method == "expectation":
        return propagate_expectation(predictions)
    raise ValueError(f"Invalid propagation method {propagation_method}.")


# ------------------------------------------------------------------------ #
# Colored noise generator (iCEM)
# ------------------------------------------------------------------------ #
def _powerlaw_from_normals(
    normal_real: torch.Tensor,
    normal_imag: torch.Tensor,
    exponent: float,
    samples: int,
    fmin: float = 0.0,
) -> torch.Tensor:
    """The (1/f)**exponent noise built from two standard-normal draws of shape
    ``(..., samples // 2 + 1)`` (the real and imaginary spectrum)."""
    dev = normal_real.device
    f = torch.fft.rfftfreq(samples, device=dev)
    fmin = max(fmin, 1.0 / samples)
    s_scale = torch.where(f < fmin, torch.full_like(f, fmin), f) ** (-exponent / 2.0)

    # theoretical output std from the scaling factors
    w = s_scale[1:].clone()
    w[-1] *= (1 + (samples % 2)) / 2.0
    sigma = 2 * torch.sqrt(torch.sum(w**2)) / samples

    sr = normal_real * s_scale
    si = normal_imag * s_scale
    if not (samples % 2):
        si[..., -1] = 0.0  # the Nyquist term of an even length is real
    si[..., 0] = 0.0  # so is the DC term
    return torch.fft.irfft(torch.complex(sr, si), n=samples, dim=-1) / sigma


def powerlaw_psd_gaussian(
    generator: torch.Generator,
    exponent: float,
    size: Union[int, Iterable[int]],
    fmin: float = 0.0,
    device: Optional[DeviceLike] = None,
) -> torch.Tensor:
    """Gaussian (1/f)**exponent noise via an inverse real FFT, normalized to
    unit variance; the power spectrum lives on the LAST axis of ``size``."""
    size = [size] if isinstance(size, int) else list(size)
    device = generator.device if device is None else device
    samples = size[-1]
    if samples < 2:
        # degenerate spectrum (a single time sample): plain unit-variance Gaussian
        return randn(generator, size, device)
    shape = tuple(size[:-1]) + (samples // 2 + 1,)
    return _powerlaw_from_normals(
        randn(generator, shape, device), randn(generator, shape, device), exponent, samples, fmin
    )
