"""Owners of the port's function boundaries that ``spans/`` names but that an
older checkout of the port lacks (``mbpo.start_rollout``,
``GaussianMLP._permute_rows`` and ``GaussianMLP._unpermute_rows``), for a
traced run to wrap.

Each owner is the port's own module or class where it has the boundary, so
the wrapper replaces the function the program calls. Where the port lacks it,
the owner is a stand-in whose function nothing calls: the wrapping succeeds,
the span stays empty and the metric that reads it reads nothing.
"""
from __future__ import annotations

import types

from mbrl_tpu_torch.algorithms import mbpo as _mbpo
from mbrl_tpu_torch.models import gaussian_mlp as _gaussian_mlp


def _absent(*args, **kwargs):
    raise RuntimeError("a stand-in for a boundary that this checkout of the port lacks")


def owner(obj, *names: str):
    """``obj`` where it has every one of ``names``, else a stand-in that has
    each as a function that nothing calls."""
    if all(hasattr(obj, name) for name in names):
        return obj
    return types.SimpleNamespace(**{name: _absent for name in names})


mbpo = owner(_mbpo, "start_rollout")
GaussianMLP = owner(_gaussian_mlp.GaussianMLP, "_permute_rows", "_unpermute_rows")
