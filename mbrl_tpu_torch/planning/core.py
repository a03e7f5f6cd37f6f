"""Agent base interfaces (counterpart of ``mbrl_tpu/planning/core.py``).
``load_agent`` comes with the slice that ports the config engine."""
from __future__ import annotations

import abc

import numpy as np


class Agent(abc.ABC):
    """An agent maps observations to actions."""

    @abc.abstractmethod
    def act(self, obs: np.ndarray, **kwargs) -> np.ndarray:
        """Issue an action for the given observation."""

    def plan(self, obs: np.ndarray, **kwargs) -> np.ndarray:
        """Issue a sequence of actions (defaults to a single-action plan)."""
        return np.asarray(self.act(obs, **kwargs))[None]

    def reset(self, **kwargs) -> None:
        """Clear any episode state."""


class RandomAgent(Agent):
    """Uniformly random actions from the env's action space."""

    def __init__(self, env):
        self.env = env

    def act(self, obs: np.ndarray, **kwargs) -> np.ndarray:
        return self.env.action_space.sample()
