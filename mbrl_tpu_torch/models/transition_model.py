"""Transition/reward wrapper (counterpart of ``mbrl_tpu/models/transition_model.py``).

Input concat with an optional ``obs_process_fn``, the input normalizer, delta
targets with ``no_delta_list`` exemptions, and the learned reward as the last
output column. The wrapper is stateless: the mutable part lives in a ``state``
dict ``{"params": model params, "normalizer": NormalizerState | None}`` (the
trainer adds ``"opt_state"``). ``model.pkl`` is a pickle of numpy arrays in
the JAX package's format, so a model saved by either package loads in the other.
"""
from __future__ import annotations

import pathlib
import pickle
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mbrl_tpu_torch.ops import normalizer as nrm
from mbrl_tpu_torch.ops.tree import tree_map
from mbrl_tpu_torch.types import TransitionBatch

_PARAMS_FNAME = "model.pkl"


class TransitionRewardModel:
    """Wraps an ensemble dynamics model with rollout semantics.

    Args:
        model: the wrapped model (GaussianMLP protocol).
        target_is_delta: predict ``next_obs - obs`` instead of ``next_obs``.
        normalize: keep input normalizer stats and normalize model inputs.
        normalize_double_precision: float64 normalizer stats (PETS default).
        learned_rewards: the model's last output column predicts reward.
        obs_process_fn: optional fn applied to observations before the concat.
        no_delta_list: observation dims exempt from delta prediction.
        num_elites: members kept as elites after training (default: all).
    """

    def __init__(
        self,
        model,
        target_is_delta: bool = True,
        normalize: bool = False,
        normalize_double_precision: bool = False,
        learned_rewards: bool = True,
        obs_process_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        no_delta_list: Optional[Sequence[int]] = None,
        num_elites: Optional[int] = None,
    ):
        self.model = model
        self.num_elites = num_elites or getattr(model, "num_members", 1)
        self.frozen_param_keys = getattr(model, "frozen_param_keys", ())
        self.normalize_double_precision = normalize_double_precision
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
            dtype = torch.float64 if self.normalize_double_precision else torch.float32
            normalizer = nrm.init_normalizer(self.model.in_size, self.device, dtype=dtype)
        return {"params": params, "normalizer": normalizer}

    def update_normalizer(
        self, state: Dict[str, Any], batch: TransitionBatch
    ) -> Dict[str, Any]:
        """Recompute normalizer stats from (processed obs, act) of the batch."""
        if not self.normalize:
            return state
        stats = state["normalizer"]

        def tensor(x):
            return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(
                device=stats.mean.device, dtype=stats.mean.dtype
            )

        obs, act = tensor(batch.obs), tensor(batch.act)
        if obs.ndim == 1:
            obs, act = obs[None], act[None]
        if self.obs_process_fn is not None:
            obs = self.obs_process_fn(obs)
        model_in = torch.cat([obs, act], dim=-1)
        return {**state, "normalizer": nrm.update_stats(stats, model_in)}

    def update_normalizer_host(
        self, state: Dict[str, Any], batch: TransitionBatch
    ) -> Dict[str, Any]:
        """Host-numpy stats recompute (``ops.normalizer.update_stats_host``);
        takes the tensor path when an ``obs_process_fn`` is configured."""
        if not self.normalize:
            return state
        if self.obs_process_fn is not None:
            return self.update_normalizer(state, batch)
        obs = np.asarray(batch.obs)
        act = np.asarray(batch.act)
        if obs.ndim == 1:
            obs, act = obs[None], act[None]
        model_in = np.concatenate([obs, act], axis=-1)
        return {**state, "normalizer": nrm.update_stats_host(state["normalizer"], model_in)}

    def _model_input(
        self, state: Dict[str, Any], obs: torch.Tensor, act: torch.Tensor
    ) -> torch.Tensor:
        if self.obs_process_fn is not None:
            obs = self.obs_process_fn(obs)
        model_in = torch.cat([obs, act], dim=-1)
        if self.normalize:
            model_in = nrm.normalize(state["normalizer"], model_in)
        return model_in.float()

    def process_batch(
        self, state: Dict[str, Any], batch: TransitionBatch
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """TransitionBatch -> (model_in, target). Leading dims pass through, so
        bootstrapped ``E x B`` batches work unchanged."""
        dev = self.device

        def f32(x):
            return torch.as_tensor(x).to(device=dev, dtype=torch.float32)

        obs, act, next_obs, rewards = f32(batch.obs), f32(batch.act), f32(batch.next_obs), f32(
            batch.rewards
        )
        if rewards.ndim == obs.ndim - 1:
            rewards = rewards[..., None]

        if self.target_is_delta:
            target_obs = next_obs - obs
            for dim in self.no_delta_list:
                target_obs[..., dim] = next_obs[..., dim]
        else:
            target_obs = next_obs

        model_in = self._model_input(state, obs, act)
        if self.learned_rewards:
            target = torch.cat([target_obs, rewards], dim=-1)
        else:
            target = target_obs
        return model_in, target

    # ------------------------------------------------------------------ #
    def loss(self, state: Dict[str, Any], batch: TransitionBatch):
        model_in, target = self.process_batch(state, batch)
        return self.model.loss(state["params"], model_in, target)

    def eval_score(self, state: Dict[str, Any], batch: TransitionBatch):
        model_in, target = self.process_batch(state, batch)
        return self.model.eval_score(state["params"], model_in, target)

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

    def save(self, state: Dict[str, Any], save_dir: Union[str, pathlib.Path]) -> None:
        """Params and normalizer stats as numpy arrays (not the Adam moments)."""
        normalizer = state.get("normalizer")
        payload = {
            "params": tree_map(lambda t: t.detach().cpu().numpy(), state["params"]),
            "normalizer": None
            if normalizer is None
            else {"mean": normalizer.mean.cpu().numpy(), "std": normalizer.std.cpu().numpy()},
        }
        with open(pathlib.Path(save_dir) / _PARAMS_FNAME, "wb") as f:
            pickle.dump(payload, f)

    def load(self, state: Dict[str, Any], load_dir: Union[str, pathlib.Path]) -> Dict[str, Any]:
        from mbrl_tpu_torch.convert import convert_params

        with open(pathlib.Path(load_dir) / _PARAMS_FNAME, "rb") as f:
            payload = pickle.load(f)
        params = convert_params(payload["params"], self.device)
        normalizer = state["normalizer"]
        if payload["normalizer"] is not None and normalizer is not None:

            def conv(x, like):
                return torch.as_tensor(np.asarray(x)).to(device=like.device, dtype=like.dtype)

            normalizer = normalizer.replace(
                mean=conv(payload["normalizer"]["mean"], normalizer.mean),
                std=conv(payload["normalizer"]["std"], normalizer.std),
            )
        return {"params": params, "normalizer": normalizer}
