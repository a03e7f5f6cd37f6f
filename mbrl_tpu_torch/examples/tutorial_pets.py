"""Tutorial: PETS on continuous cartpole, assembled by hand from the library
API (counterpart of ``mbrl_tpu/examples/tutorial_pets.py``).

The script-form equivalent of the reference's pets_example.ipynb notebook: build a
dynamics model + model env + CEM agent without the config system, train on the fly,
and print learning progress. The model, its training and the planner run on
``device``; on the card each planning step is kernel K2.

Run: ``python -m mbrl_tpu_torch.examples.tutorial_pets [--steps 2000] [--device cpu]``
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.envs import CartPoleEnv, reward_fns, termination_fns
from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, ModelTrainer, TransitionRewardModel
from mbrl_tpu_torch.planning import (
    CEMOptimizer,
    RandomAgent,
    TrajectoryOptimizerAgent,
    create_trajectory_optim_agent_for_model,
)
from mbrl_tpu_torch.util import common as util_common
from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer


def main(num_steps: int = 2000, trial_length: int = 200, seed: int = 0,
         device: DeviceLike = "cuda") -> float:
    env = CartPoleEnv()
    obs_dim = env.observation_space.shape[0]
    act_dim = env.action_space.shape[0]
    generator = torch.Generator().manual_seed(seed)

    # 1. Dynamics model: 5-member probabilistic ensemble, learned delta targets,
    #    analytic cartpole reward (so the model only learns dynamics).
    model = GaussianMLP(
        in_size=obs_dim + act_dim,
        out_size=obs_dim,
        num_layers=3,
        ensemble_size=5,
        hid_size=128,
        activation="silu",
        propagation_method="random_model",
        device=device,
    )
    wrapper = TransitionRewardModel(
        model, target_is_delta=True, normalize=True, learned_rewards=False,
        num_elites=4,
    )
    state = wrapper.init(generator)

    # 2. Imagined environment + trainer.
    model_env = ModelEnv(wrapper, termination_fns.cartpole, reward_fns.cartpole)
    trainer = ModelTrainer(wrapper, optim_lr=1e-3, weight_decay=5e-5)

    # 3. CEM MPC agent over the imagined environment.
    horizon = 15
    cem = CEMOptimizer(
        num_iterations=5,
        elite_ratio=0.1,
        population_size=350,
        lower_bound=np.tile(env.action_space.low, (horizon, 1)).tolist(),
        upper_bound=np.tile(env.action_space.high, (horizon, 1)).tolist(),
        alpha=0.1,
        return_mean_elites=True,
        device=device,
    )
    agent = TrajectoryOptimizerAgent(
        cem, env.action_space.low, env.action_space.high,
        planning_horizon=horizon, replan_freq=1, seed=seed + 1,
    )
    agent = create_trajectory_optim_agent_for_model(model_env, agent, num_particles=20)
    agent.set_eval_state(state)

    # 4. Seed the buffer with random exploration.
    buffer = ReplayBuffer(num_steps + 1000, (obs_dim,), (act_dim,))
    util_common.rollout_agent_trajectories(
        env, 200, RandomAgent(env), {}, replay_buffer=buffer, trial_length=trial_length
    )

    # 5. PETS loop: retrain every 50 steps, act by MPC.
    env_steps = 0
    best = -np.inf
    while env_steps < num_steps:
        obs, _ = env.reset()
        agent.reset()
        total, done, trunc, t = 0.0, False, False, 0
        while not (done or trunc) and t < trial_length:
            if env_steps % 50 == 0:
                train_it, val_it = util_common.get_basic_buffer_iterators(
                    buffer, 256, 0.1, ensemble_size=len(wrapper)
                )
                state = wrapper.update_normalizer(state, buffer.get_all())
                state, _, _ = trainer.train(
                    state, train_it, val_it, num_epochs=10, patience=4
                )
                agent.set_eval_state(state)
            obs, r, done, trunc, _ = util_common.step_env_and_add_to_buffer(
                env, obs, agent, {}, buffer
            )
            total += r
            t += 1
            env_steps += 1
        best = max(best, total)
        print(f"steps {env_steps:5d} | episode reward {total:6.1f} | best {best:6.1f}")
    return best


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()
    main(args.steps, seed=args.seed, device=args.device)
