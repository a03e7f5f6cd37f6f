"""Shared dataclasses and typedefs (counterpart of ``mbrl_tpu/types.py``).

A ``TransitionBatch`` holds numpy arrays on the host side (replay buffer,
iterators) and tensors on the device side (``TransitionBatch.to``); its
"methods" return new batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]

# (act, next_obs) -> terminated flags (B, 1) bool, batched
TermFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (act, next_obs) -> rewards (B, 1), batched
RewardFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class TransitionBatch:
    """A batch of environment transitions (leading batch dims arbitrary)."""

    obs: Array
    act: Array
    next_obs: Array
    rewards: Array
    terminateds: Array
    truncateds: Array

    def __len__(self) -> int:
        return int(self.obs.shape[0])

    def astuple(self) -> Tuple[Array, Array, Array, Array, Array, Array]:
        return (self.obs, self.act, self.next_obs, self.rewards, self.terminateds,
                self.truncateds)

    def map(self, fn: Callable[[Array], Any]) -> "TransitionBatch":
        """A new batch with ``fn`` applied to every leaf."""
        return TransitionBatch(*(fn(x) for x in self.astuple()))

    def __getitem__(self, item) -> "TransitionBatch":
        return self.map(lambda x: x[item])

    @property
    def shape(self):
        return tuple(self.obs.shape)

    def add_new_batch_dim(self, batch_size: int) -> "TransitionBatch":
        """Reshape leading axis N into (N // batch_size, batch_size)."""
        n = len(self)
        if n % batch_size != 0:
            raise ValueError("Current batch of transitions not compatible with new batch size")
        return self.map(
            lambda x: x.reshape((n // batch_size, batch_size) + tuple(x.shape[1:]))
        )

    def to(self, device, dtype: torch.dtype = torch.float32) -> "TransitionBatch":
        """All leaves as tensors on ``device``, cast to ``dtype`` (bools stay bool)."""

        def conv(x):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            if t.dtype == torch.bool:
                return t.to(device)
            return t.to(device=device, dtype=dtype)

        return self.map(conv)


def transition_batch_like(
    obs: Array,
    act: Array,
    next_obs: Optional[Array] = None,
    rewards: Optional[Array] = None,
    terminateds: Optional[Array] = None,
    truncateds: Optional[Array] = None,
) -> TransitionBatch:
    """Build a TransitionBatch, zero-filling missing fields (shape-compatible)."""
    b = np.shape(obs)[0]
    if next_obs is None:
        next_obs = np.zeros_like(obs)
    if rewards is None:
        rewards = np.zeros((b, 1), dtype=np.float32)
    if terminateds is None:
        terminateds = np.zeros((b, 1), dtype=bool)
    if truncateds is None:
        truncateds = np.zeros((b, 1), dtype=bool)
    return TransitionBatch(obs, act, next_obs, rewards, terminateds, truncateds)
