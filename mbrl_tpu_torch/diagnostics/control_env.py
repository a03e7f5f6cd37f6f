"""True-dynamics trajectory optimization over a pool of real-env workers
(counterpart of ``mbrl_tpu/diagnostics/control_env.py``).

Capability parity with the reference ``mbrl/diagnostics/control_env.py`` (the repo's
only multiprocess code: an mp.Pool with a per-worker global env :25-35, CEM
planning where every candidate action sequence is evaluated on the REAL environment
via state set/rollout/restore :38-61, pool at :145-147).

One CEM implementation for the whole framework: the shared
:class:`~mbrl_tpu_torch.planning.CEMOptimizer` update rule, on ``device``,
with the real-environment worker pool as its objective. Each CEM iteration
moves the population to the host once and maps it over the pool; the workers
step host simulators only and touch no device.
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import time

import numpy as np
import torch

from mbrl_tpu_torch.config import Config
from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.util.env import EnvHandler, create_handler_from_str, make_env_from_name

env__: object = None
handler__: EnvHandler = None


def init_worker(env_name: str, seed: int):
    """Initialize a per-worker global environment."""
    global env__, handler__
    handler__ = create_handler_from_str(env_name)
    env__ = make_env_from_name(Config({"overrides": {"env": env_name}}), env_name)
    env__.reset(seed=seed)


def evaluate_sequence_fn(args) -> float:
    """Evaluate one action sequence from a given env state on the real dynamics."""
    action_sequence, current_state = args
    handler__.set_env_state(current_state, env__)
    total = 0.0
    for action in action_sequence:
        _, reward, terminated, truncated, _ = env__.step(action)
        total += reward
        if terminated or truncated:
            break
    return total


class TrueDynamicsController:
    """CEM planning against the real environment via a worker pool."""

    def __init__(
        self,
        env_name: str,
        horizon: int,
        population_size: int,
        num_iterations: int,
        elite_ratio: float = 0.1,
        alpha: float = 0.1,
        num_workers: int = 4,
        seed: int = 0,
        *,
        device: DeviceLike = "cuda",
    ):
        from mbrl_tpu_torch.planning import CEMOptimizer

        self.env_name = env_name
        self.horizon = horizon
        self.population_size = population_size
        self.num_iterations = num_iterations
        self.alpha = alpha

        self.handler = create_handler_from_str(env_name)
        self.env = make_env_from_name(Config({"overrides": {"env": env_name}}), env_name)
        self.env.reset(seed=seed)
        self.action_lb = self.env.action_space.low
        self.action_ub = self.env.action_space.high

        self._cem = CEMOptimizer(
            num_iterations=num_iterations,
            elite_ratio=elite_ratio,
            population_size=population_size,
            lower_bound=np.tile(self.action_lb, (horizon, 1)).tolist(),
            upper_bound=np.tile(self.action_ub, (horizon, 1)).tolist(),
            alpha=alpha,
            return_mean_elites=False,  # best-ever sequence
            device=device,
        )
        self._current_state = None
        self._generator = torch.Generator().manual_seed(seed)
        self._x0 = torch.as_tensor(
            np.tile((self.action_lb + self.action_ub) / 2, (horizon, 1)),
            dtype=torch.float32, device=self._cem.device,
        )
        # forkserver: the parent has live threads (torch's) by now, so forking
        # it directly risks deadlocks in inherited locks
        self.pool = mp.get_context("forkserver").Pool(
            processes=num_workers, initializer=init_worker, initargs=(env_name, seed)
        )

    def _objective(self, population: torch.Tensor) -> torch.Tensor:
        """The population's real returns: one copy to the host, one map over
        the pool, the values back on the optimizer's device."""
        pop = population.cpu().numpy().astype(np.float64)
        values = self.pool.map(evaluate_sequence_fn, [(seq, self._current_state) for seq in pop])
        return torch.as_tensor(np.asarray(values, np.float32), device=population.device)

    def plan(self, current_state) -> np.ndarray:
        """One CEM plan with every candidate evaluated on the real env."""
        self._current_state = current_state
        sol, _ = self._cem.optimize(self._objective, self._x0, self._generator)
        return sol.cpu().numpy()

    def run_episode(self, max_steps: int = 200, verbose: bool = False) -> float:
        obs, _ = self.env.reset()
        total_reward = 0.0
        for step in range(max_steps):
            t0 = time.time()
            state = self.handler.get_current_state(self.env)
            plan = self.plan(state)
            obs, reward, terminated, truncated, _ = self.env.step(plan[0])
            total_reward += reward
            if verbose:
                print(f"step {step}: reward {reward:.3f} plan_time {time.time()-t0:.2f}s")
            if terminated or truncated:
                break
        return total_reward

    def close(self):
        self.pool.close()
        self.pool.join()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", type=str, default="cartpole_continuous")
    parser.add_argument("--horizon", type=int, default=15)
    parser.add_argument("--population", type=int, default=64)
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    controller = TrueDynamicsController(
        args.env, args.horizon, args.population, args.iterations,
        num_workers=args.workers, device=args.device,
    )
    reward = controller.run_episode(args.steps, verbose=True)
    print(f"episode reward: {reward}")
    controller.close()
