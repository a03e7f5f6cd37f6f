"""CEM trajectory optimizer and the MPC agent (counterpart of
``mbrl_tpu/planning/trajectory_opt.py``).

PyTorch is eager, so each optimizer's ``optimize`` is a plain loop over
generations, and ``TrajectoryOptimizerAgent.act`` is a plain loop in place of
the JAX package's fused device program. Randomness comes from an explicit
``torch.Generator``. ``MPPIOptimizer``, ``ICEMOptimizer``, ``act_batch`` and
``use_prng_impl`` come with later slices.
"""
from __future__ import annotations

import copy
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike, randn, resolve_device
from mbrl_tpu_torch.ops.math import truncated_normal
from mbrl_tpu_torch.planning.core import Agent


def _nan_guard(values: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(values), torch.full_like(values, -1e-10), values)


class Optimizer:
    """Base: maximize obj_fun(population, *obj_args) over sequences of shape (H, A).

    ``init_state()`` returns the persistent cross-call state (may be ());
    ``optimize`` returns (best_solution, new_state).
    """

    def init_state(self):
        return ()

    def reset_state(self, opt_state):
        return self.init_state()

    def optimize(self, obj_fun, x0, generator, opt_state=(), obj_args=(), callback=None):
        raise NotImplementedError

    def for_horizon(self, action_lb: np.ndarray, action_ub: np.ndarray, horizon: int):
        """A copy whose (H, A) bounds are the action bounds tiled over ``horizon``."""
        new = copy.copy(self)
        new.lower_bound = torch.as_tensor(
            np.tile(action_lb, (horizon, 1)), dtype=torch.float32, device=self.device
        )
        new.upper_bound = torch.as_tensor(
            np.tile(action_ub, (horizon, 1)), dtype=torch.float32, device=self.device
        )
        return new


class CEMOptimizer(Optimizer):
    """CEM_PETS: truncated-normal (or clipped-normal) population around a running
    (mu, dispersion), top-k elites, momentum updates, best-ever or elite-mean return."""

    def __init__(
        self,
        num_iterations: int,
        elite_ratio: float,
        population_size: int,
        lower_bound: Sequence[Sequence[float]],
        upper_bound: Sequence[Sequence[float]],
        alpha: float,
        return_mean_elites: bool = False,
        clipped_normal: bool = False,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.num_iterations = num_iterations
        self.population_size = population_size
        self.elite_num = int(np.ceil(population_size * elite_ratio))
        self.lower_bound = torch.as_tensor(lower_bound, dtype=torch.float32, device=self.device)
        self.upper_bound = torch.as_tensor(upper_bound, dtype=torch.float32, device=self.device)
        self.alpha = alpha
        self.return_mean_elites = return_mean_elites
        self.clipped_normal = clipped_normal

    def _sample(self, generator, mu, dispersion):
        shape = (self.population_size,) + tuple(mu.shape)
        if self.clipped_normal:
            pop = mu + dispersion * randn(generator, shape, self.device)
            return torch.clamp(pop, self.lower_bound, self.upper_bound)
        lb_dist = mu - self.lower_bound
        ub_dist = self.upper_bound - mu
        mv = torch.minimum(torch.square(lb_dist / 2), torch.square(ub_dist / 2))
        constrained_var = torch.minimum(mv, dispersion)
        noise = truncated_normal(generator, shape, device=self.device)
        return noise * torch.sqrt(constrained_var) + mu

    def optimize(self, obj_fun, x0, generator, opt_state=(), obj_args=(), callback=None):
        """Returns ``(solution (H, A), opt_state)``; ``callback(population,
        values, iteration)`` runs after every generation."""
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        mu = x0
        dispersion = (
            torch.ones_like(x0)
            if self.clipped_normal
            else torch.square(self.upper_bound - self.lower_bound) / 16.0
        )
        best_sol = x0
        best_val = torch.tensor(-float("inf"), device=self.device)
        for i in range(self.num_iterations):
            population = self._sample(generator, mu, dispersion)
            values = _nan_guard(obj_fun(population, *obj_args))
            if callback is not None:
                callback(population, values, i)
            elite_values, elite_idx = torch.topk(values, self.elite_num)
            elite = population[elite_idx]
            new_mu = elite.mean(dim=0)
            new_disp = (
                elite.std(dim=0, unbiased=False)
                if self.clipped_normal
                else elite.var(dim=0, unbiased=False)
            )
            mu = self.alpha * mu + (1 - self.alpha) * new_mu
            dispersion = self.alpha * dispersion + (1 - self.alpha) * new_disp
            # best-ever tracking without a host sync
            improved = elite_values[0] > best_val
            best_sol = torch.where(improved, population[elite_idx[0]], best_sol)
            best_val = torch.maximum(best_val, elite_values[0])
        return (mu if self.return_mean_elites else best_sol), opt_state


class TrajectoryOptimizer:
    """Shapes action-sequence optimization problems as (H, A) and warm-starts.

    The initial solution is the midpoint of the action bounds tiled over the
    horizon; after each plan the previous solution is shifted by
    ``replan_freq`` with the initial solution filling the tail.
    """

    def __init__(
        self,
        optimizer: Optimizer,
        action_lb: np.ndarray,
        action_ub: np.ndarray,
        planning_horizon: int,
        replan_freq: int = 1,
        keep_last_solution: bool = True,
    ):
        self.optimizer = optimizer
        self.horizon = planning_horizon
        self.replan_freq = replan_freq
        self.keep_last_solution = keep_last_solution
        mid = (np.asarray(action_lb, np.float32) + np.asarray(action_ub, np.float32)) / 2
        device = getattr(optimizer, "device", torch.device("cpu"))
        self.initial_solution = torch.as_tensor(mid, device=device).reshape(1, -1).repeat(
            planning_horizon, 1
        )
        self.previous_solution = self.initial_solution.clone()
        self.opt_state = optimizer.init_state()

    def optimize(self, obj_fun, generator, obj_args=(), callback=None) -> np.ndarray:
        solution, self.opt_state = self.optimizer.optimize(
            obj_fun, self.previous_solution, generator, self.opt_state, obj_args,
            callback=callback,
        )
        if self.keep_last_solution:
            shifted = torch.roll(solution, -self.replan_freq, dims=0)
            shifted[-self.replan_freq :] = self.initial_solution[0]
            self.previous_solution = shifted
        return solution.cpu().numpy()

    def reset(self):
        self.previous_solution = self.initial_solution.clone()
        self.opt_state = self.optimizer.reset_state(self.opt_state)


class TrajectoryOptimizerAgent(Agent):
    """MPC agent: plans a horizon, caches ``replan_freq`` actions, re-plans when
    the cache empties. The trajectory evaluation function is set after
    construction (``set_trajectory_eval_fn``)."""

    def __init__(
        self,
        optimizer: Optimizer,
        action_lb: Sequence[float],
        action_ub: Sequence[float],
        planning_horizon: int = 1,
        replan_freq: int = 1,
        verbose: bool = False,
        keep_last_solution: bool = True,
        seed: int = 0,
    ):
        self._action_lb = np.asarray(action_lb, np.float32)
        self._action_ub = np.asarray(action_ub, np.float32)
        self.optimizer = TrajectoryOptimizer(
            optimizer,
            self._action_lb,
            self._action_ub,
            planning_horizon=planning_horizon,
            replan_freq=replan_freq,
            keep_last_solution=keep_last_solution,
        )
        self.trajectory_eval_fn = None
        self._eval_state: Any = None
        self.actions_to_use: List[np.ndarray] = []
        self.replan_freq = replan_freq
        self.verbose = verbose
        self._generator = torch.Generator().manual_seed(seed)
        self._act_counter = 0  # plans made by act()

    @property
    def device(self) -> torch.device:
        return self.optimizer.initial_solution.device

    def set_trajectory_eval_fn(self, trajectory_eval_fn) -> None:
        """trajectory_eval_fn(action_sequences, eval_state, obs, generator) -> values."""
        self.trajectory_eval_fn = trajectory_eval_fn

    def set_eval_state(self, eval_state) -> None:
        """Update the state passed to the eval fn (e.g. trained model state)."""
        self._eval_state = eval_state

    def reset(self, planning_horizon: Optional[int] = None) -> None:
        """Clear the action cache and warm start; a new ``planning_horizon``
        rebuilds the trajectory optimizer, and the optimizer's (H, A) bounds,
        from the agent's real action bounds (mbrl-lib semantics; the JAX
        reference passes ``initial_solution[0]`` as both bounds here, a fault
        not copied)."""
        if planning_horizon:
            self.optimizer = TrajectoryOptimizer(
                self.optimizer.optimizer.for_horizon(
                    self._action_lb, self._action_ub, planning_horizon
                ),
                self._action_lb,
                self._action_ub,
                planning_horizon=planning_horizon,
                replan_freq=self.replan_freq,
                keep_last_solution=self.optimizer.keep_last_solution,
            )
        self.optimizer.reset()
        self.actions_to_use = []

    def _plan(self, obs, optimizer_callback=None) -> np.ndarray:
        if self.trajectory_eval_fn is None:
            raise RuntimeError(
                "Call set_trajectory_eval_fn() before using TrajectoryOptimizerAgent"
            )
        obs_t = torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)
        obj_args = (self._eval_state, obs_t, self._generator)
        return self.optimizer.optimize(
            self.trajectory_eval_fn, self._generator, obj_args=obj_args,
            callback=optimizer_callback,
        )

    def act(self, obs: np.ndarray, optimizer_callback=None, **_kwargs) -> np.ndarray:
        plan_time = 0.0
        if not self.actions_to_use:
            start = time.time()
            plan = self._plan(obs, optimizer_callback)
            self._act_counter += 1
            self.actions_to_use.extend(list(plan[: self.replan_freq]))
            plan_time = time.time() - start
        action = self.actions_to_use.pop(0)
        if self.verbose:
            print(f"Planning time: {plan_time:.3f}")
        return action

    def plan(self, obs: np.ndarray, optimizer_callback=None, **_kwargs) -> np.ndarray:
        return self._plan(obs, optimizer_callback)


def create_trajectory_optim_agent_for_model(
    model_env,
    agent: TrajectoryOptimizerAgent,
    num_particles: int = 1,
) -> TrajectoryOptimizerAgent:
    """Bind an agent's objective to ModelEnv.evaluate_action_sequences. The
    model's wrapper state is passed via ``set_eval_state``."""

    def trajectory_eval_fn(action_sequences, eval_state, obs, generator):
        return model_env.evaluate_action_sequences(
            eval_state, action_sequences, obs, generator, num_particles=num_particles
        )

    agent.set_trajectory_eval_fn(trajectory_eval_fn)
    return agent
