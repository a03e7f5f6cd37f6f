"""Function typedefs (counterpart of ``mbrl_tpu/types.py``).

``TransitionBatch`` comes with the training slice, which is the first to need it.
"""
from __future__ import annotations

from typing import Callable

import torch

# (act, next_obs) -> terminated flags (B, 1) bool, batched
TermFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# (act, next_obs) -> rewards (B, 1), batched
RewardFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
