"""Batched multi-dimensional PID controller agent (counterpart of
``mbrl_tpu/planning/linear_feedback.py``): per-dimension proportional, integral
and derivative gains against a setpoint, an optional ``state_mapping`` that
picks the state entries each controller reads, batched over a second axis.
Host numpy in float64, as there; it does no device work.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mbrl_tpu_torch.planning.core import Agent


class PIDAgent(Agent):
    def __init__(
        self,
        k_p: np.ndarray,
        k_i: np.ndarray,
        k_d: np.ndarray,
        target: np.ndarray,
        state_mapping: Optional[np.ndarray] = None,
        batch_dim: int = 1,
    ):
        k_p, k_i, k_d, target = (np.asarray(x, np.float64) for x in (k_p, k_i, k_d, target))
        if not (len(k_p) == len(k_i) == len(k_d) == len(target)):
            raise ValueError("PID gain/target vectors must share a length")
        self.n_dof = len(k_p)
        if state_mapping is not None:
            state_mapping = np.asarray(state_mapping)
            if len(state_mapping) != len(target):
                raise ValueError("state_mapping must match the number of controllers")
            self.state_mapping = state_mapping
        else:
            self.state_mapping = np.arange(self.n_dof)
        self.batch_dim = batch_dim

        def tile(v):
            return np.repeat(v[:, None], batch_dim, axis=1)

        self.k_p, self.k_i, self.k_d = tile(k_p), tile(k_i), tile(k_d)
        self.target = tile(target)
        self.reset()

    def act(self, obs: np.ndarray, **_kwargs) -> np.ndarray:
        """PID action for an ``N`` or ``N x B`` observation -> ``n_dof x B``."""
        if obs.ndim == 1:
            obs = obs[:, None]
        pos = obs[self.state_mapping] if len(obs) > self.n_dof else obs
        error = self.target - pos
        self._cum_error = self._cum_error + error
        action = (
            self.k_p * error
            + self.k_i * self._cum_error
            + self.k_d * (error - self._prev_error)
        )
        self._prev_error = error
        return action

    def reset(self, **_kwargs) -> None:
        self._prev_error = np.zeros((self.n_dof, self.batch_dim))
        self._cum_error = np.zeros((self.n_dof, self.batch_dim))

    def get_errors(self):
        return self._prev_error, self._cum_error

    def get_parameters(self) -> np.ndarray:
        """[P gains, I gains, D gains, targets], flattened."""
        return np.stack((self.k_p, self.k_i, self.k_d, self.target)).flatten()
