"""Input normalizer state (counterpart of ``mbrl_tpu/ops/normalizer.py``).

Full-recompute mean/std over the dataset, small-std clamping to 1.0, float32
or float64 stats (PETS keeps them in float64; the model input is cast to
float32 after normalizing).
"""
from __future__ import annotations

import dataclasses
import pathlib
import pickle
from typing import Union

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike

_STATS_FNAME = "env_stats.pickle"


@dataclasses.dataclass
class NormalizerState:
    mean: torch.Tensor  # (1, in_size)
    std: torch.Tensor  # (1, in_size)
    eps: float = 1e-5

    def replace(self, **changes) -> "NormalizerState":
        return dataclasses.replace(self, **changes)


def init_normalizer(
    in_size: int, device: DeviceLike, dtype: torch.dtype = torch.float32
) -> NormalizerState:
    return NormalizerState(
        mean=torch.zeros((1, in_size), dtype=dtype, device=device),
        std=torch.ones((1, in_size), dtype=dtype, device=device),
        eps=1e-12 if dtype == torch.float64 else 1e-5,
    )


def _check_shape(state: NormalizerState, shape) -> None:
    if len(shape) != 2 or shape[1] != state.mean.shape[1]:
        raise ValueError(
            f"Normalizer expected (N, {state.mean.shape[1]}) data, got {tuple(shape)}"
        )


def update_stats(state: NormalizerState, data) -> NormalizerState:
    """Full recompute of mean/std from ``data`` (N x in_size); std<eps -> 1.0."""
    data = torch.as_tensor(data).to(device=state.mean.device, dtype=state.mean.dtype)
    _check_shape(state, data.shape)
    mean = data.mean(dim=0, keepdim=True)
    std = data.std(dim=0, keepdim=True, unbiased=True)
    std = torch.where(std < state.eps, torch.ones_like(std), std)
    return state.replace(mean=mean, std=std)


def update_stats_host(state: NormalizerState, data: np.ndarray) -> NormalizerState:
    """Host-numpy counterpart of :func:`update_stats`: the reduction runs on the
    CPU, where the replay buffer lives, and only the (1, in_size) results go to
    the device."""
    np_dtype = np.float64 if state.mean.dtype == torch.float64 else np.float32
    data = np.asarray(data, dtype=np_dtype)
    _check_shape(state, data.shape)
    mean = data.mean(axis=0, keepdims=True)
    std = data.std(axis=0, keepdims=True, ddof=1)
    std = np.where(std < state.eps, 1.0, std).astype(np_dtype)
    dev = state.mean.device
    return state.replace(
        mean=torch.as_tensor(mean).to(dev), std=torch.as_tensor(std).to(dev)
    )


def normalize(state: NormalizerState, val: torch.Tensor) -> torch.Tensor:
    return (val - state.mean) / state.std


def denormalize(state: NormalizerState, val: torch.Tensor) -> torch.Tensor:
    return state.std * val + state.mean


def save(state: NormalizerState, save_dir: Union[str, pathlib.Path]) -> None:
    with open(pathlib.Path(save_dir) / _STATS_FNAME, "wb") as f:
        pickle.dump({"mean": state.mean.cpu().numpy(), "std": state.std.cpu().numpy()}, f)


def load(state: NormalizerState, results_dir: Union[str, pathlib.Path]) -> NormalizerState:
    with open(pathlib.Path(results_dir) / _STATS_FNAME, "rb") as f:
        stats = pickle.load(f)

    def conv(x, like):
        return torch.as_tensor(np.asarray(x)).to(device=like.device, dtype=like.dtype)

    return state.replace(mean=conv(stats["mean"], state.mean), std=conv(stats["std"], state.std))
