"""A small ``Box`` space, so that the port's own environments need no
``gymnasium``: ``low``, ``high``, ``shape``, ``dtype``, ``seed``, ``sample``."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Box:
    """An axis-aligned box in R^n with a generator of its own for ``sample``."""

    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32,
                 seed: Optional[int] = None):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, dtype=self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype=self.dtype), self.shape).copy()
        self._rng = np.random.default_rng(seed)

    def seed(self, seed: Optional[int] = None) -> None:
        self._rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        """Uniform in [low, high] where both are finite; a standard normal in
        an unbounded dimension."""
        bounded = np.isfinite(self.low) & np.isfinite(self.high)
        out = self._rng.standard_normal(self.shape)
        uniform = self._rng.uniform(
            np.where(bounded, self.low, 0.0), np.where(bounded, self.high, 1.0)
        )
        return np.where(bounded, uniform, out).astype(self.dtype)

