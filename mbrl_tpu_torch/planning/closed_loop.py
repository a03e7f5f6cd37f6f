"""Closed-loop MPC driver: plan -> act -> model step, for K steps (counterpart
of ``mbrl_tpu/planning/closed_loop.py``).

For simulated and parity workloads the "real" environment can itself be a
model (or any dynamics with ``ModelEnv``'s interface), so the whole control
loop runs on the device: the full CEM, iCEM or MPPI optimisation, the first
action with a warm-started solution, the surrogate environment's step and the
reward bookkeeping; the host fetches the trajectory at the end.

The JAX package runs the loop as one jitted ``lax.scan``. Here it is a Python
loop over device tensors: a step enqueues its plan (``Optimizer.optimize`` over
``ModelEnv.evaluate_action_sequences``, which takes the kernels' rollout) and
its ``ModelEnv.step`` (K3 on an ensemble's equal shards) and reads nothing back,
so the host runs ahead of the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch


class ClosedLoopDriver:
    """Runs K MPC steps: plan with ``optimizer`` over ``plan_env``, step
    ``act_env``.

    ``plan_env`` and ``act_env`` are ModelEnv-like; they may be the same object
    (plan and act in one learned model) or differ (e.g. plan in a small model,
    act in a bigger surrogate). Each plan warm-starts from the previous
    solution shifted left by one step, with a zero tail.
    """

    def __init__(
        self,
        plan_env,
        optimizer,
        horizon: int,
        act_dim: int,
        num_particles: int,
        act_env=None,
        sample_env_step: bool = True,
    ):
        self.plan_env = plan_env
        self.act_env = act_env if act_env is not None else plan_env
        self.optimizer = optimizer
        self.horizon = horizon
        self.act_dim = act_dim
        self.num_particles = num_particles
        self.sample_env_step = sample_env_step

    def _objective(self, population, state, obs, generator):
        return self.plan_env.evaluate_action_sequences(
            state, population, obs, generator, num_particles=self.num_particles
        )

    def _act_rows(self, act_state: Dict[str, Any]) -> int:
        """Rows the surrogate environment steps: an ensemble's elite count (its
        equal-shard propagation needs a multiple of it), else 1; row 0 is read."""
        model = getattr(self.act_env.dynamics_model, "model", None)
        if model is None or getattr(model, "ensemble_size", 1) <= 1:
            return 1
        params = act_state["params"]
        return int(params["elite"].shape[0]) if "elite" in params else model.ensemble_size

    def run(
        self,
        plan_state: Dict[str, Any],
        obs0,
        generator: torch.Generator,
        num_steps: int,
        act_state: Optional[Dict[str, Any]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``num_steps`` closed-loop MPC steps; returns ``(obs_traj, actions,
        rewards, terminateds)`` on the optimizer's device, each with leading
        axis ``num_steps``."""
        if act_state is None:
            act_state = plan_state
        device = self.optimizer.device
        n_rows = self._act_rows(act_state)
        obs0 = torch.as_tensor(obs0, dtype=torch.float32, device=device)
        obs_rows = obs0.expand((n_rows,) + tuple(obs0.shape)).contiguous()
        env_state = self.act_env.reset(act_state, obs_rows, generator)

        solution = torch.zeros((self.horizon, self.act_dim), device=device)
        tail = torch.zeros((1, self.act_dim), device=device)
        opt_state = self.optimizer.init_state()
        observations, actions, rewards, terminateds = [], [], [], []
        for _ in range(num_steps):
            # warm start: the previous solution shifted left one step, zero
            # tail (MPPI ignores x0 and shifts its own mean: no double shift)
            x0 = torch.cat([solution[1:], tail])
            solution, opt_state = self.optimizer.optimize(
                self._objective, x0, generator, opt_state,
                obj_args=(plan_state, obs_rows[0], generator),
            )
            action = solution[0].expand(n_rows, self.act_dim)
            next_obs, reward, terminated, env_state = self.act_env.step(
                act_state, action, env_state, generator, sample=self.sample_env_step
            )
            observations.append(obs_rows[0])
            actions.append(solution[0])
            rewards.append(reward.reshape(-1)[0])
            terminateds.append(terminated.reshape(-1)[0])
            obs_rows = next_obs
        return (torch.stack(observations), torch.stack(actions), torch.stack(rewards),
                torch.stack(terminateds))
