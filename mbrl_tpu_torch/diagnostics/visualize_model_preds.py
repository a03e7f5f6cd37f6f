"""Visualizer: model-predicted vs. real rollouts with uncertainty bands
(counterpart of ``mbrl_tpu/diagnostics/visualize_model_preds.py``).

Capability parity with the reference ``mbrl/diagnostics/visualize_model_preds.py``
(Visualizer:23-304): from a saved experiment, roll an agent in the REAL env (inside a
freeze so physics state restores), roll the same plan in the MODEL env with multiple
samples, and plot per-dimension trajectories with min/max envelopes over model
samples, one PNG per plan.

The rollouts (:meth:`Visualizer.rollouts`, :meth:`Visualizer.compute`) run
the planner and the model on the model's device and return numpy arrays;
``matplotlib`` is imported only to draw them.
"""
from __future__ import annotations

import argparse
import pathlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from mbrl_tpu_torch.config import Config, complete_agent_cfg, instantiate
from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.diagnostics.common import load_experiment
from mbrl_tpu_torch.models import ModelEnv
from mbrl_tpu_torch.planning import RandomAgent, create_trajectory_optim_agent_for_model
from mbrl_tpu_torch.util import common as util_common
from mbrl_tpu_torch.util.env import create_handler


class Visualizer:
    def __init__(
        self,
        lookahead: int,
        results_dir: str,
        agent_dir: Optional[str] = None,
        num_steps: Optional[int] = None,
        num_model_samples: int = 1,
        model_subdir: Optional[str] = None,
        *,
        cfg: Optional[Config] = None,
        device: DeviceLike = "cuda",
    ):
        self.lookahead = lookahead
        self.results_path = pathlib.Path(results_dir)
        self.num_steps = num_steps
        self.num_model_samples = num_model_samples
        self.vis_path = self.results_path / "diagnostics"
        self.vis_path.mkdir(parents=True, exist_ok=True)

        (
            self.cfg,
            self.env,
            self.dynamics_model,
            self.model_state,
            _,
            term_fn,
            reward_fn,
        ) = load_experiment(results_dir, load_buffer=False, cfg=cfg, device=device)
        self.handler = create_handler(self.cfg)
        self.model_env = ModelEnv(self.dynamics_model, term_fn, reward_fn)
        self.generator = torch.Generator().manual_seed(0)

        if agent_dir is None:
            self.agent = RandomAgent(self.env)
        else:
            agent_cfg = complete_agent_cfg(self.env, self.cfg.algorithm.agent, device=device)
            agent = instantiate(agent_cfg)
            self.agent = create_trajectory_optim_agent_for_model(
                self.model_env, agent,
                num_particles=self.cfg.algorithm.get("num_particles", 1),
            )
            self.agent.set_eval_state(self.model_state)

    def rollouts(self, obs: np.ndarray, plan: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``plan`` from ``obs`` in the real environment (restored afterwards),
        ``(T + 1, obs)``, and in the model with ``num_model_samples`` samples,
        ``(T + 1, samples, obs)``."""
        real_obses, _, _ = self.handler.rollout_env(self.env, obs, self.lookahead, plan=plan)
        model_obses, _, _ = util_common.rollout_model_env(
            self.model_env,
            self.model_state,
            obs,
            self.generator,
            plan=plan,
            num_samples=self.num_model_samples,
        )
        return real_obses, model_obses

    def compute(self) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """One plan every ``lookahead`` steps over ``num_steps`` (default one
        plan): ``(env step, real rollout, model rollouts)`` for each; the real
        environment advances by each plan's first action."""
        obs, _ = self.env.reset(seed=self.cfg.get("seed", 0))
        out = []
        steps = self.num_steps or self.lookahead
        for step in range(0, steps, self.lookahead):
            plan = np.asarray(self.agent.plan(obs))[: self.lookahead]
            real_obses, model_obses = self.rollouts(obs, plan)
            out.append((step, real_obses, model_obses))
            # actually advance the real env with the first action
            obs, *_ = self.env.step(plan[0])
        return out

    def run(self) -> None:
        self.plot(self.compute())

    def plot(self, rollouts: List[Tuple[int, np.ndarray, np.ndarray]]) -> None:
        """One ``pred_step<i>.png`` per plan."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for i, (step, real_obses, model_obses) in enumerate(rollouts):
            fig = self._plot_step(step, real_obses, model_obses, plt)
            fig.savefig(self.vis_path / f"pred_step{i:03d}.png", dpi=100)
            plt.close(fig)

    def _plot_step(self, step, real_obses, model_obses, plt):
        num_dims = real_obses.shape[-1]
        cols = min(4, num_dims)
        rows = (num_dims + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False)
        t_real = np.arange(real_obses.shape[0])
        t_model = np.arange(model_obses.shape[0])
        for d in range(num_dims):
            ax = axes[d // cols][d % cols]
            ax.plot(t_real, real_obses[:, d], "k-", label="real")
            mean = model_obses[:, :, d].mean(axis=1)
            lo = model_obses[:, :, d].min(axis=1)
            hi = model_obses[:, :, d].max(axis=1)
            ax.plot(t_model, mean, "r-", label="model")
            ax.fill_between(t_model, lo, hi, color="r", alpha=0.2)
            ax.set_title(f"dim {d}", fontsize=8)
            if d == 0:
                ax.legend(fontsize=7)
        fig.suptitle(f"env step {step}")
        return fig


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiments_dir", type=str, required=True)
    parser.add_argument("--lookahead", type=int, default=25)
    parser.add_argument("--agent_dir", type=str, default=None)
    parser.add_argument("--num_steps", type=int, default=None)
    parser.add_argument("--model_samples", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    Visualizer(
        args.lookahead, args.experiments_dir, args.agent_dir,
        num_steps=args.num_steps, num_model_samples=args.model_samples, device=args.device,
    ).run()
