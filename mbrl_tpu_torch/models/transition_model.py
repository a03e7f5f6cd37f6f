"""Transition/reward wrapper (counterpart of ``mbrl_tpu/models/transition_model.py``).

Input concat with an optional ``obs_process_fn``, the input normalizer, delta
targets with ``no_delta_list`` exemptions, and the learned reward as the last
output column. The wrapper is stateless: the mutable part lives in a ``state``
dict ``{"params": model params, "normalizer": NormalizerState | None}``.
Normalizer updates and save/load come with the training slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from mbrl_tpu_torch.ops import normalizer as nrm


class TransitionRewardModel:
    """Wraps an ensemble dynamics model with rollout semantics.

    Args:
        model: the wrapped model (GaussianMLP protocol).
        target_is_delta: predict ``next_obs - obs`` instead of ``next_obs``.
        normalize: keep input normalizer stats and normalize model inputs.
        learned_rewards: the model's last output column predicts reward.
        obs_process_fn: optional fn applied to observations before the concat.
        no_delta_list: observation dims exempt from delta prediction.
    """

    def __init__(
        self,
        model,
        target_is_delta: bool = True,
        normalize: bool = False,
        learned_rewards: bool = True,
        obs_process_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        no_delta_list: Optional[Sequence[int]] = None,
    ):
        self.model = model
        self.target_is_delta = target_is_delta
        self.normalize = normalize
        self.learned_rewards = learned_rewards
        self.obs_process_fn = obs_process_fn
        self.no_delta_list = tuple(no_delta_list or ())

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        params = self.model.init(generator)
        normalizer = None
        if self.normalize:
            normalizer = nrm.init_normalizer(self.model.in_size, self.device)
        return {"params": params, "normalizer": normalizer}

    def _model_input(
        self, state: Dict[str, Any], obs: torch.Tensor, act: torch.Tensor
    ) -> torch.Tensor:
        if self.obs_process_fn is not None:
            obs = self.obs_process_fn(obs)
        model_in = torch.cat([obs, act], dim=-1)
        if self.normalize:
            model_in = nrm.normalize(state["normalizer"], model_in)
        return model_in.float()

    # ------------------------------------------------------------------ #
    def reset(
        self, state: Dict[str, Any], obs: torch.Tensor, generator: torch.Generator
    ) -> Dict[str, Any]:
        """Start simulated trajectories from a batch of observations."""
        return self.model.reset_1d(obs, generator)

    def prepare_rollout(
        self,
        state: Dict[str, Any],
        model_state: Dict[str, Any],
        horizon: int,
        generator: torch.Generator,
    ) -> Dict[str, Any]:
        inner = getattr(self.model, "prepare_rollout", None)
        if inner is None:
            return model_state
        return inner(state["params"], model_state, horizon, generator)

    def sample(
        self,
        state: Dict[str, Any],
        act: torch.Tensor,
        model_state: Dict[str, Any],
        generator: torch.Generator,
        deterministic: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
        """One simulated transition: (next_obs, rewards_or_None, next_model_state)."""
        obs = model_state["obs"]
        model_in = self._model_input(state, obs, act)
        preds, next_model_state = self.model.sample_1d(
            state["params"], model_in, model_state, generator, deterministic=deterministic
        )
        next_obs = preds[:, :-1] if self.learned_rewards else preds
        if self.target_is_delta:
            full = next_obs + obs
            for dim in self.no_delta_list:
                full[:, dim] = next_obs[:, dim]
            next_obs = full
        rewards = preds[:, -1:] if self.learned_rewards else None
        next_model_state = {**next_model_state, "obs": next_obs}
        return next_obs, rewards, next_model_state

    # ------------------------------------------------------------------ #
    def set_propagation_method(self, propagation_method: Optional[str] = None) -> None:
        if hasattr(self.model, "propagation_method"):
            self.model.propagation_method = propagation_method

    def set_elite(self, state: Dict[str, Any], elite_indices) -> Dict[str, Any]:
        return {**state, "params": self.model.set_elite(state["params"], elite_indices)}

    def __len__(self) -> int:
        return len(self.model)
