"""The model contract (counterpart of ``mbrl_tpu/models/base.py``).

Any object with these methods plugs into ``TransitionRewardModel``,
``ModelEnv`` and ``ModelTrainer``: the protocols below document that surface
over tensors and explicit ``torch.Generator``s (``GaussianMLP``,
``BasicEnsemble`` and ``PlaNetModel`` satisfy them structurally).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

import torch

Params = Dict[str, Any]

# The three PETS trajectory-sampling modes
PROPAGATION_METHODS = ("random_model", "fixed_model", "expectation")


@runtime_checkable
class DynamicsModel(Protocol):
    """A raw tensor model: (stacked) params and forward/loss/eval functions."""

    in_size: int
    out_size: int
    deterministic: bool

    def init(self, generator: torch.Generator) -> Params:
        """Create the parameter tree."""

    def forward(
        self, params: Params, x: torch.Tensor, use_only_elite: bool = False
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """All-member forward -> (mean, logvar|None), member axis leading."""

    def loss(
        self, params: Params, model_in: torch.Tensor, target: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Training loss (scalar) and metadata."""

    def eval_score(
        self, params: Params, model_in: torch.Tensor, target: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Non-reduced per-member validation score."""


@runtime_checkable
class EnsembleModel(DynamicsModel, Protocol):
    """A dynamics model with the 1-D simulation contract used by ModelEnv."""

    ensemble_size: int
    propagation_method: Optional[str]

    def reset_1d(self, obs: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Start simulated trajectories: the model state
        ({"obs", "propagation_indices"})."""

    def sample_1d(
        self,
        params: Params,
        model_input: torch.Tensor,
        model_state: Dict[str, torch.Tensor],
        generator: torch.Generator,
        deterministic: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One stochastic transition under the configured propagation mode."""

    def sample_propagation_indices(
        self, batch_size: int, generator: torch.Generator
    ) -> torch.Tensor:
        """Persistent per-trajectory member assignment (TSinf)."""

    def set_elite(self, params: Params, elite_indices) -> Params:
        """Params with a new elite member set."""
