"""Model-as-environment: batched imagined rollouts of a learned dynamics model
(counterpart of ``mbrl_tpu/models/model_env.py``).

``evaluate_action_sequences`` takes the shard-space fast path
(``models/fast_rollout.py``) when the wrapped model supports it, and otherwise
the generic per-step loop: reset → prepare_rollout → H × sample, with
terminated particles masked by a carried ``alive`` flag.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from mbrl_tpu_torch.models import fast_rollout
from mbrl_tpu_torch.types import RewardFn, TermFn


class ModelEnv:
    """Gym-like batched environment backed by a TransitionRewardModel.

    Learned rewards are used iff ``reward_fn is None``. Terminal prediction is
    analytic via ``termination_fn``. ``particle_sharding`` (a multi-device
    particle layout) comes with the parallel slice and must be None.
    """

    def __init__(
        self,
        dynamics_model,
        termination_fn: TermFn,
        reward_fn: Optional[RewardFn] = None,
        particle_sharding=None,
    ):
        if particle_sharding is not None:
            raise NotImplementedError("particle_sharding is not ported yet; pass None")
        self.dynamics_model = dynamics_model
        self.termination_fn = termination_fn
        self.reward_fn = reward_fn
        self.particle_sharding = particle_sharding

    @property
    def device(self) -> torch.device:
        return self.dynamics_model.device

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ #
    def reset(
        self, state: Dict[str, Any], initial_obs_batch, generator: torch.Generator
    ) -> Dict[str, Any]:
        """Initialize model state for a batch of simulated trajectories."""
        return self.dynamics_model.reset(state, self._tensor(initial_obs_batch), generator)

    def step(
        self,
        state: Dict[str, Any],
        actions,
        model_state: Dict[str, Any],
        generator: torch.Generator,
        sample: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """One simulated step for a batch of particles."""
        actions = self._tensor(actions)
        next_obs, pred_rewards, next_model_state = self.dynamics_model.sample(
            state, actions, model_state, generator, deterministic=not sample
        )
        rewards = pred_rewards if self.reward_fn is None else self.reward_fn(actions, next_obs)
        terminated = self.termination_fn(actions, next_obs)
        return next_obs, rewards, terminated, next_model_state

    # ------------------------------------------------------------------ #
    def evaluate_action_sequences(
        self,
        state: Dict[str, Any],
        action_sequences,
        initial_obs,
        generator: torch.Generator,
        num_particles: int,
    ) -> torch.Tensor:
        """Expected return of each candidate action sequence under the model:
        particles masked after termination, mean over particles per sequence.
        Returns ``(population,)`` values."""
        action_sequences = self._tensor(action_sequences)
        initial_obs = self._tensor(initial_obs)
        population, horizon, _ = action_sequences.shape
        batch = population * num_particles
        if fast_rollout.supports_fast_rollout(self.dynamics_model, state, batch):
            return fast_rollout.evaluate_action_sequences_sharded(
                self.dynamics_model,
                state,
                action_sequences,
                initial_obs,
                generator,
                num_particles,
                reward_fn=self.reward_fn,
                termination_fn=self.termination_fn,
            )
        init_obs = initial_obs.expand((batch,) + initial_obs.shape).contiguous()
        model_state = self.dynamics_model.reset(state, init_obs, generator)
        prepare = getattr(self.dynamics_model, "prepare_rollout", None)
        if prepare is not None:
            model_state = prepare(state, model_state, horizon, generator)

        total = torch.zeros((batch,), dtype=torch.float32, device=self.device)
        alive = torch.ones((batch,), dtype=torch.bool, device=self.device)
        for t in range(horizon):
            act_batch = action_sequences[:, t].repeat_interleave(num_particles, dim=0)
            next_obs, pred_rewards, model_state = self.dynamics_model.sample(
                state, act_batch, model_state, generator
            )
            rewards = (
                pred_rewards if self.reward_fn is None else self.reward_fn(act_batch, next_obs)
            )
            rewards = rewards.reshape(batch)
            terminated = self.termination_fn(act_batch, next_obs).reshape(batch)
            total = total + torch.where(alive, rewards, torch.zeros_like(rewards))
            alive = alive & ~terminated
        return total.reshape(population, num_particles).mean(dim=1)

    def make_trajectory_eval_fn(self, num_particles: int) -> Callable:
        """Bind a (state, action_sequences, initial_obs, generator) -> values
        closure for trajectory optimizer agents."""
        return partial(self.evaluate_action_sequences, num_particles=num_particles)
