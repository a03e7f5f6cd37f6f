"""Weight bridge: the JAX ``TransitionRewardModel`` state, as numpy arrays, to
the port's state on a given device.

Input layout (``mbrl_tpu/models/gaussian_mlp.py:122-154``)::

    {"params": {"layers": [{"w": (E, d_in, d_out), "b": (E, 1, d_out)}, ...],
                "head": {"w": (E, hid, head_out), "b": (E, 1, head_out)},
                "elite": (n_elite,) int,
                "min_logvar": (1, out), "max_logvar": (1, out)},   # unless deterministic
     "normalizer": None | object or mapping with "mean"/"std" (1, in_size)}

Every leaf is a numpy array (e.g. ``jax.tree_util.tree_map(np.asarray, state)``);
this module never sees JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike, resolve_device
from mbrl_tpu_torch.models.gaussian_mlp import as_dtype
from mbrl_tpu_torch.ops.normalizer import NormalizerState


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device).to(dtype).contiguous()


def _stat(normalizer, name: str):
    if isinstance(normalizer, Mapping):
        return normalizer[name]
    return getattr(normalizer, name)


def convert_params(
    params: Mapping[str, Any], device: DeviceLike = "cuda", compute_dtype=None
) -> Dict[str, Any]:
    """GaussianMLP params (numpy leaves) → the port's params dict. With
    ``compute_dtype``, the weight stack (layer and head weights) is cast to it;
    biases and logvar bounds stay float32."""
    dev = resolve_device(device)
    wdt = torch.float32 if compute_dtype is None else as_dtype(compute_dtype)
    out: Dict[str, Any] = {
        "layers": [
            {"w": _tensor(l["w"], dev, wdt), "b": _tensor(l["b"], dev)}
            for l in params["layers"]
        ],
        "head": {"w": _tensor(params["head"]["w"], dev, wdt), "b": _tensor(params["head"]["b"], dev)},
        "elite": _tensor(params["elite"], dev, torch.int64),
    }
    for key in ("min_logvar", "max_logvar"):
        if key in params:
            out[key] = _tensor(params[key], dev)
    return out


def convert_state(
    state: Mapping[str, Any], device: DeviceLike = "cuda", compute_dtype=None
) -> Dict[str, Any]:
    """JAX ``TransitionRewardModel`` state (numpy leaves) → the port's state."""
    dev = resolve_device(device)
    normalizer: Optional[NormalizerState] = None
    if state.get("normalizer") is not None:
        n = state["normalizer"]
        normalizer = NormalizerState(
            mean=_tensor(_stat(n, "mean"), dev),
            std=_tensor(_stat(n, "std"), dev),
        )
    return {
        "params": convert_params(state["params"], dev, compute_dtype),
        "normalizer": normalizer,
    }
