"""A step cap for the port's environments (counterpart of
``gymnasium.wrappers.TimeLimit``, which ``mbrl_tpu/util/env.py`` wraps every
environment in): after ``max_episode_steps`` steps of an episode, ``step``
reports ``truncated``. Plain Python, no ``gymnasium``."""
from __future__ import annotations

from typing import Any, Tuple


class TimeLimit:
    """Wraps an environment with ``reset`` and ``step``; every other attribute
    is the wrapped environment's."""

    def __init__(self, env, max_episode_steps: int):
        self.env = env
        self._max_episode_steps = int(max_episode_steps)
        self._elapsed_steps = None

    def __getattr__(self, name: str) -> Any:
        if name == "env":  # not yet set (unpickling)
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def reset(self, **kwargs):
        self._elapsed_steps = 0
        return self.env.reset(**kwargs)

    def step(self, action) -> Tuple[Any, float, bool, bool, dict]:
        if self._elapsed_steps is None:
            raise RuntimeError("step before reset")
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self._max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info
