"""CEM, MPPI and iCEM trajectory optimizers and the MPC agent (counterpart of
``mbrl_tpu/planning/trajectory_opt.py``).

PyTorch is eager, so each optimizer's ``optimize`` is a plain loop over
generations, ``TrajectoryOptimizerAgent.act`` is a plain loop in place of the
JAX package's fused device program, and ``act_batch`` is a loop over the
environments, each with its own planner state and generator stream.
Randomness comes from an explicit ``torch.Generator``; the JAX package's
``use_prng_impl`` (a choice of key implementation) has no counterpart.
"""
from __future__ import annotations

import copy
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike, randn, randperm, resolve_device
from mbrl_tpu_torch.ops.math import powerlaw_psd_gaussian, truncated_normal
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


class MPPIOptimizer(Optimizer):
    """Model Predictive Path Integral: β-smoothed correlated noise, exponential
    reward weighting, persistent shifted mean across calls (carried as
    ``opt_state``; ``x0`` is ignored, so callers must NOT pre-shift)."""

    def __init__(
        self,
        num_iterations: int,
        population_size: int,
        gamma: float,
        sigma: float,
        beta: float,
        lower_bound: Sequence[Sequence[float]],
        upper_bound: Sequence[Sequence[float]],
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.refinements = num_iterations
        self.population_size = population_size
        self.gamma = gamma
        self.beta = beta
        self.lower_bound = torch.as_tensor(lower_bound, dtype=torch.float32, device=self.device)
        self.upper_bound = torch.as_tensor(upper_bound, dtype=torch.float32, device=self.device)
        self.sigma = sigma  # kept for the config's sake: see `optimize`

    @property
    def horizon(self) -> int:
        return self.lower_bound.shape[0]

    @property
    def action_dim(self) -> int:
        return self.lower_bound.shape[1]

    def init_state(self):
        return torch.zeros((self.horizon, self.action_dim), device=self.device)

    def optimize(self, obj_fun, x0, generator, opt_state=None, obj_args=(), callback=None):
        if opt_state is None or (isinstance(opt_state, tuple) and opt_state == ()):
            opt_state = self.init_state()
        mean = opt_state
        past_action = mean[0]
        mean = torch.cat([mean[1:], mean[-1:]], dim=0)  # the persistent mean, shifted one step
        beta = self.beta
        for k in range(self.refinements):
            # The population is built from the UNSCALED truncated noise: mbrl-lib
            # and the JAX package compute the noise scaled by sigma (constrained
            # by the bounds) and drop it, so sigma never reaches the candidates.
            noise = truncated_normal(
                generator, (self.population_size, self.horizon, self.action_dim),
                device=self.device,
            )
            # β-smoothing across time: a_t = β(mean_t + n_t) + (1-β) a_{t-1}
            drive = beta * (mean[None] + noise)
            population = torch.empty_like(noise)
            prev = past_action[None]
            for t in range(self.horizon):
                prev = drive[:, t] + (1 - beta) * prev
                population[:, t] = prev
            population = torch.clamp(population, self.lower_bound, self.upper_bound)

            values = _nan_guard(obj_fun(population, *obj_args))
            if callback is not None:
                callback(population, values, k)
            weights = torch.exp(self.gamma * (values - values.max()))[:, None, None]
            mean = (population * weights).sum(dim=0) / (weights.sum() + 1e-10)
        return mean, mean


class ICEMOptimizer(Optimizer):
    """iCEM: colored-noise populations with exponentially decayed size, elite
    reuse across iterations and calls, mean appended at the last iteration.

    Population sizes per iteration are fixed at construction
    (``decay_population_sizes``, rounded up to ``population_size_module``).
    At the last iteration the running mean joins the population as one
    candidate, also when the last iteration is the first
    (``num_iterations == 1``: shifted elites and the mean), which is
    mbrl-lib's behaviour; the JAX package drops the mean in that case.
    """

    def __init__(
        self,
        num_iterations: int,
        elite_ratio: float,
        population_size: int,
        population_decay_factor: float,
        colored_noise_exponent: float,
        lower_bound: Sequence[Sequence[float]],
        upper_bound: Sequence[Sequence[float]],
        keep_elite_frac: float,
        alpha: float,
        return_mean_elites: bool = False,
        population_size_module: Optional[int] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.num_iterations = num_iterations
        self.elite_num = int(np.ceil(population_size * elite_ratio))
        self.colored_noise_exponent = colored_noise_exponent
        self.lower_bound = torch.as_tensor(lower_bound, dtype=torch.float32, device=self.device)
        self.upper_bound = torch.as_tensor(upper_bound, dtype=torch.float32, device=self.device)
        self.alpha = alpha
        self.return_mean_elites = return_mean_elites

        def round_up(value: int, module: Optional[int]) -> int:
            if not module or value % module == 0:
                return value
            return value + module - value % module

        self.keep_elite_size = round_up(
            int(np.ceil(keep_elite_frac * self.elite_num)), population_size_module
        )
        self.decay_population_sizes = [
            round_up(
                int(np.ceil(max(population_size * population_decay_factor**-i,
                                2 * self.elite_num))),
                population_size_module,
            )
            for i in range(num_iterations)
        ]

    @property
    def horizon(self) -> int:
        return self.lower_bound.shape[0]

    @property
    def action_dim(self) -> int:
        return self.lower_bound.shape[1]

    def init_state(self):
        # (elite set, valid flag): a zeroed elite set with valid=False stands
        # for "no elites yet" (the first call of an episode)
        return {
            "elite": torch.zeros((self.elite_num, self.horizon, self.action_dim),
                                 device=self.device),
            "valid": False,
        }

    def optimize(self, obj_fun, x0, generator, opt_state=None, obj_args=(), callback=None):
        if opt_state is None or (isinstance(opt_state, tuple) and opt_state == ()):
            opt_state = self.init_state()
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        mu = x0
        var = torch.square(self.upper_bound - self.lower_bound) / 16.0
        best_sol = x0
        best_val = torch.tensor(-float("inf"), device=self.device)
        elite, elite_valid = opt_state["elite"], bool(opt_state["valid"])
        last = self.num_iterations - 1

        for i, pop_size in enumerate(self.decay_population_sizes):
            # colored noise correlated along time (the last axis of the generator)
            noise = powerlaw_psd_gaussian(
                generator, self.colored_noise_exponent,
                (pop_size, self.action_dim, self.horizon), device=self.device,
            )
            population = noise.transpose(1, 2) * torch.sqrt(var) + mu
            population = torch.clamp(population, self.lower_bound, self.upper_bound)

            # elite reuse: a random subset of the kept elites (the mean stands
            # in for them while there are none yet)
            keep = randperm(generator, self.elite_num, self.device)[: self.keep_elite_size]
            kept = elite[keep]
            if i == 0:
                end_action = mu[-1] + torch.sqrt(var[-1]) * randn(
                    generator, (self.keep_elite_size, self.action_dim), self.device
                )
                kept = torch.cat([kept[:, 1:, :], end_action[:, None, :]], dim=1)
            if not elite_valid:
                kept = mu.expand_as(kept)
            if i == last:
                # the running mean as ONE candidate at the last iteration; it
                # replaces the kept elites unless that iteration is also the first
                kept = torch.cat([kept, mu[None]], dim=0) if i == 0 else mu[None]
            population = torch.cat([population, kept], dim=0)

            values = _nan_guard(obj_fun(population, *obj_args))
            if callback is not None:
                callback(population, values, i)
            elite_values, elite_idx = torch.topk(values, self.elite_num)
            elite = population[elite_idx]
            elite_valid = True

            mu = self.alpha * mu + (1 - self.alpha) * elite.mean(dim=0)
            var = self.alpha * var + (1 - self.alpha) * elite.var(dim=0, unbiased=False)

            improved = elite_values[0] > best_val
            best_sol = torch.where(improved, population[elite_idx[0]], best_sol)
            best_val = torch.maximum(best_val, elite_values[0])

        out = mu if self.return_mean_elites else best_sol
        return out, {"elite": elite, "valid": elite_valid}


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
        device = getattr(optimizer, "device", None)
        if device is None:
            raise ValueError(
                f"{type(optimizer).__name__} has no `device`: the trajectory optimizer keeps "
                "its solutions on the optimizer's device and never picks one itself"
            )
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
        self._seed = seed
        self._generator = torch.Generator().manual_seed(seed)
        self._act_counter = 0  # plans made by act()
        self._batch_state = None  # act_batch: per-environment planners, generators, cache

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
        self._batch_state = None

    def _plan(self, obs, optimizer_callback=None, planner=None, generator=None) -> np.ndarray:
        if self.trajectory_eval_fn is None:
            raise RuntimeError(
                "Call set_trajectory_eval_fn() before using TrajectoryOptimizerAgent"
            )
        planner = self.optimizer if planner is None else planner
        generator = self._generator if generator is None else generator
        obs_t = torch.as_tensor(np.asarray(obs), dtype=torch.float32, device=self.device)
        obj_args = (self._eval_state, obs_t, generator)
        with torch.no_grad():
            return planner.optimize(
                self.trajectory_eval_fn, generator, obj_args=obj_args,
                callback=optimizer_callback,
            )

    def batch_generator(self, worker: int) -> torch.Generator:
        """The generator stream of environment ``worker`` in ``act_batch``."""
        return torch.Generator().manual_seed(self._seed * 1_000_003 + worker + 1)

    def act_batch(
        self, obs_batch: np.ndarray, reset_mask: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """MPC actions for a batch of W observations, ``(W, A)``.

        Each environment has its own warm start, optimizer state and generator
        stream, which persist across calls; ``reset_mask[w]=True`` resets
        environment w's planner state (an episode boundary) and makes everyone
        re-plan. ``replan_freq`` actions per environment are cached, as in
        :meth:`act`. The W plans run one after the other."""
        if self.trajectory_eval_fn is None:
            raise RuntimeError(
                "Call set_trajectory_eval_fn() before using TrajectoryOptimizerAgent"
            )
        obs_batch = np.asarray(obs_batch, np.float32)
        w = obs_batch.shape[0]
        st = self._batch_state
        if st is None or st["w"] != w:
            proto = self.optimizer
            st = {
                "w": w,
                "planners": [
                    TrajectoryOptimizer(
                        proto.optimizer, self._action_lb, self._action_ub,
                        planning_horizon=proto.horizon, replan_freq=proto.replan_freq,
                        keep_last_solution=proto.keep_last_solution,
                    )
                    for _ in range(w)
                ],
                "generators": [self.batch_generator(i) for i in range(w)],
                "cache": [],  # list of (W, A) action rows
            }
            self._batch_state = st
        if reset_mask is not None and np.any(reset_mask):
            for i in np.flatnonzero(np.asarray(reset_mask, bool)):
                st["planners"][i].reset()
            st["cache"] = []  # replan everyone at a boundary
        if not st["cache"]:
            plans = np.stack([
                self._plan(obs_batch[i], planner=st["planners"][i],
                           generator=st["generators"][i])[: self.replan_freq]
                for i in range(w)
            ])  # (W, rf, A)
            st["cache"] = [plans[:, i] for i in range(plans.shape[1])]
        return st["cache"].pop(0)

    def act(self, obs: np.ndarray, optimizer_callback=None, **_kwargs) -> np.ndarray:
        if _kwargs.get("batched"):
            return self.act_batch(obs, reset_mask=_kwargs.get("reset_mask"))
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
