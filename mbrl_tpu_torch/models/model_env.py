"""Model-as-environment: batched imagined rollouts of a learned dynamics model
(counterpart of ``mbrl_tpu/models/model_env.py``).

``evaluate_action_sequences`` takes the shard-space fast path
(``models/fast_rollout.py``) when the wrapped model supports it, and otherwise
the generic per-step loop: reset → prepare_rollout → H × sample, with
terminated particles masked by a carried ``alive`` flag.

With a ``particle_sharding`` over a data axis of more than one rank
(``parallel.ParallelContext.particle_sharding``), each rank does its share
of the work of the ``population x particles`` rows, and every rank ends with
the whole batch's returns:

  - the fast path keeps its kernels (K1 or K2) on each rank's rows. A rank
    takes a block of the candidate sequences with all their particles, and
    draws from a generator seeded from the shared one and its place on the
    data axis, so no two ranks repeat a noise stream;
  - the generic path keeps the whole batch on every rank and draws the
    randomness of the whole batch there (the propagation's permutations and
    indices, the Gaussian noise). Each step, a rank runs the model on its
    block of the elites, each on the rows the propagation gives it, and one
    all-reduce gives every rank the whole batch's prediction
    (``GaussianMLP._forward_split``): the ranks reproduce the one-rank values.

A batch the data axis does not divide is evaluated whole on every rank, as
the JAX ``ModelEnv`` leaves an uneven batch unsharded; so is a model that
samples only whole batches (no ``mesh_particles``).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from mbrl_tpu_torch.device import seed_words
from mbrl_tpu_torch.models import fast_rollout
from mbrl_tpu_torch.types import RewardFn, TermFn
from mbrl_tpu_torch.util import profiling


class ModelEnv:
    """Gym-like batched environment backed by a TransitionRewardModel.

    Learned rewards are used iff ``reward_fn is None``. Terminal prediction is
    analytic via ``termination_fn``. ``particle_sharding`` (a
    ``parallel.mesh.Sharding`` of the particle axis over ``data``) splits the
    particles over the mesh's ranks (module docstring).
    """

    def __init__(
        self,
        dynamics_model,
        termination_fn: TermFn,
        reward_fn: Optional[RewardFn] = None,
        particle_sharding=None,
    ):
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

    # ------------------------------------------------------------------ #
    def _split(self, batch: int) -> bool:
        """Whether a batch of ``batch`` rows splits over the data axis."""
        sh = self.particle_sharding
        return sh is not None and sh.parts > 1 and batch % sh.parts == 0

    def shard(self, model_state: Dict[str, Any]) -> Dict[str, Any]:
        """A simulated batch's model state (``reset``, then
        ``prepare_rollout``, as on one rank) whose steps split their work over
        the data axis (``sharding``; module docstring). Unchanged when the
        batch is computed whole on every rank."""
        if not getattr(self.dynamics_model, "mesh_particles", False):
            return model_state
        if not self._split(model_state["obs"].shape[0]):
            return model_state
        return {**model_state, "sharding": self.particle_sharding}

    @profiling.span("ModelEnv.step")
    def step(
        self,
        state: Dict[str, Any],
        actions,
        model_state: Dict[str, Any],
        generator: torch.Generator,
        sample: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """One simulated step for a batch of particles (on a model state from
        :meth:`shard`, the ranks split the model's work)."""
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
        split = self._split(batch)
        fast = fast_rollout.supports_fast_rollout(self.dynamics_model, state, batch)
        if fast and not split:
            return self._fast(state, action_sequences, initial_obs, generator, num_particles)
        if fast:
            sh = self.particle_sharding
            mesh, axis = sh.mesh, sh.spec[0]
            if population % sh.parts == 0 and fast_rollout.supports_fast_rollout(
                self.dynamics_model, state, batch // sh.parts
            ):
                # a block of sequences, from a generator of this rank's own:
                # one seed word of the shared stream and the rank's place
                own = torch.Generator(device=generator.device).manual_seed(
                    seed_words(generator, 1)[0] * sh.parts + mesh.coords[axis])
                block = mesh.block(population, axis)
                values = self._fast(state, action_sequences[block], initial_obs, own,
                                    num_particles)
                return mesh.gather(values, axis)
        init_obs = initial_obs.expand((batch,) + initial_obs.shape).contiguous()
        model_state = self.dynamics_model.reset(state, init_obs, generator)
        prepare = getattr(self.dynamics_model, "prepare_rollout", None)
        if prepare is not None:
            model_state = prepare(state, model_state, horizon, generator)
        model_state = self.shard(model_state)

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

    def _fast(self, state, action_sequences, initial_obs, generator, num_particles):
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

    def make_trajectory_eval_fn(self, num_particles: int) -> Callable:
        """Bind a (state, action_sequences, initial_obs, generator) -> values
        closure for trajectory optimizer agents."""
        return partial(self.evaluate_action_sequences, num_particles=num_particles)
