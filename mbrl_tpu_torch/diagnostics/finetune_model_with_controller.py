"""FineTuner: continue training a saved model on data collected by a saved
agent (counterpart of ``mbrl_tpu/diagnostics/finetune_model_with_controller.py``).

Capability parity with the reference
``mbrl/diagnostics/finetune_model_with_controller.py`` (FineTuner:23-124): load a
model from one results dir and an agent from another, collect fresh transitions with
the agent, then train the model on the combined data and save to a new subdir.
The model, its planner and its training run on ``device``.
"""
from __future__ import annotations

import argparse
import pathlib
from typing import Optional

import numpy as np
import torch

from mbrl_tpu_torch.config import Config, complete_agent_cfg, instantiate
from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.diagnostics.common import load_experiment
from mbrl_tpu_torch.models import ModelEnv, ModelTrainer
from mbrl_tpu_torch.planning import RandomAgent, create_trajectory_optim_agent_for_model, load_agent
from mbrl_tpu_torch.util import common as util_common


class FineTuner:
    def __init__(
        self,
        model_dir: str,
        agent_dir: str,
        agent_type: str = "planner",
        seed: int = 0,
        subdir: str = "finetune",
        new_model: bool = False,
        *,
        cfg: Optional[Config] = None,
        device: DeviceLike = "cuda",
    ):
        (
            self.cfg,
            self.env,
            self.dynamics_model,
            self.model_state,
            self.replay_buffer,
            term_fn,
            reward_fn,
        ) = load_experiment(model_dir, cfg=cfg, device=device)
        if new_model:
            self.model_state = self.dynamics_model.init(torch.Generator().manual_seed(seed))
        self.model_env = ModelEnv(self.dynamics_model, term_fn, reward_fn)

        if agent_type == "random":
            self.agent = RandomAgent(self.env)
        elif agent_type == "planner":
            agent_cfg = complete_agent_cfg(self.env, self.cfg.algorithm.agent, device=device)
            agent = instantiate(agent_cfg, seed=seed)
            self.agent = create_trajectory_optim_agent_for_model(
                self.model_env, agent,
                num_particles=self.cfg.algorithm.get("num_particles", 1),
            )
            self.agent.set_eval_state(self.model_state)
        else:
            self.agent = load_agent(agent_dir, self.env, device=device)

        self.outdir = pathlib.Path(model_dir) / subdir
        self.outdir.mkdir(parents=True, exist_ok=True)

    def run(
        self,
        batch_size: int,
        val_ratio: float,
        num_epochs: int,
        patience: int,
        steps_to_collect: int,
    ) -> None:
        util_common.rollout_agent_trajectories(
            self.env,
            steps_to_collect,
            self.agent,
            {},
            replay_buffer=self.replay_buffer,
            trial_length=self.cfg.overrides.get("trial_length", None),
        )
        trainer = ModelTrainer(
            self.dynamics_model,
            optim_lr=self.cfg.overrides.model_lr,
            weight_decay=self.cfg.overrides.model_wd,
        )
        train_it, val_it = util_common.get_basic_buffer_iterators(
            self.replay_buffer, batch_size, val_ratio,
            ensemble_size=len(self.dynamics_model), shuffle_each_epoch=True,
        )
        self.model_state = self.dynamics_model.update_normalizer(
            self.model_state, self.replay_buffer.get_all()
        )
        self.model_state, train_losses, val_scores = trainer.train(
            self.model_state, train_it, val_it,
            num_epochs=num_epochs, patience=patience,
        )
        self.dynamics_model.save(self.model_state, str(self.outdir))
        self.replay_buffer.save(self.outdir)
        np.savez(
            self.outdir / "finetune_losses.npz",
            train=np.asarray(train_losses),
            val=np.asarray(val_scores),
        )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--agent_dir", type=str, default=None)
    parser.add_argument("--agent_type", type=str, default="planner")
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--val_ratio", type=float, default=0.1)
    parser.add_argument("--num_epochs", type=int, default=50)
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--num_steps", type=int, default=10000)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    FineTuner(args.model_dir, args.agent_dir or args.model_dir, args.agent_type,
              device=args.device).run(
        args.batch_size, args.val_ratio, args.num_epochs, args.patience, args.num_steps
    )
