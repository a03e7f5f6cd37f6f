"""Agent base interfaces and the saved-agent loader (counterpart of
``mbrl_tpu/planning/core.py``)."""
from __future__ import annotations

import abc
import pathlib

import numpy as np


class Agent(abc.ABC):
    """An agent maps observations to actions."""

    @abc.abstractmethod
    def act(self, obs: np.ndarray, **kwargs) -> np.ndarray:
        """Issue an action for the given observation."""

    def plan(self, obs: np.ndarray, **kwargs) -> np.ndarray:
        """Issue a sequence of actions (defaults to a single-action plan)."""
        return np.asarray(self.act(obs, **kwargs))[None]

    def reset(self, **kwargs) -> None:
        """Clear any episode state."""


class RandomAgent(Agent):
    """Uniformly random actions from the env's action space."""

    def __init__(self, env):
        self.env = env

    def act(self, obs: np.ndarray, **kwargs) -> np.ndarray:
        return self.env.action_space.sample()


def load_agent(agent_path, env, *, cfg=None, device="cuda"):
    """Reconstruct a saved agent from a results directory, on ``device``.

    The directory holds the run's composed ``config.yaml`` (read by
    ``diagnostics.common.load_run_config`` unless ``cfg`` is given) and the
    agent's checkpoint: for MBPO's SAC, ``sac.pkl`` (this package's, or the
    JAX package's, carried across by ``convert.convert_sac_state``) or else a
    reference ``sac.pth``; for PETS, the saved ensemble (``model.pkl``), which
    is rebuilt with the run's MPC planner (seed 1). Parity: reference
    ``mbrl/planning/core.py:126-157``, which reloads SAC agents only.
    """
    agent_path = pathlib.Path(agent_path)
    if cfg is None:
        from mbrl_tpu_torch.diagnostics.common import load_run_config

        cfg = load_run_config(agent_path)

    if cfg.algorithm.name == "mbpo":
        from mbrl_tpu_torch.planning.sac import SAC, SACAgent

        sac = SAC(
            num_inputs=env.observation_space.shape[0],
            action_space=env.action_space,
            gamma=cfg.overrides.sac_gamma,
            tau=cfg.overrides.sac_tau,
            alpha=cfg.overrides.sac_alpha,
            policy=cfg.overrides.sac_policy,
            target_update_interval=cfg.overrides.sac_target_update_interval,
            automatic_entropy_tuning=cfg.overrides.sac_automatic_entropy_tuning,
            hidden_size=cfg.overrides.sac_hidden_size,
            lr=cfg.overrides.sac_lr,
            target_entropy=cfg.overrides.get("sac_target_entropy", None),
            device=device,
        )
        if (agent_path / "sac.pkl").exists():
            state = sac.load_checkpoint(agent_path / "sac.pkl")
        else:
            # reference-trained run dir: torch pranz24 checkpoint
            state = sac.load_torch_checkpoint(agent_path / "sac.pth")
        return SACAgent(sac, state)
    if cfg.algorithm.name == "pets":
        import torch

        from mbrl_tpu_torch.config import complete_agent_cfg, create_one_dim_tr_model, instantiate
        from mbrl_tpu_torch.models import ModelEnv
        from mbrl_tpu_torch.planning.trajectory_opt import create_trajectory_optim_agent_for_model
        from mbrl_tpu_torch.util.env import create_handler

        _, term_fn, reward_fn = create_handler(cfg).make_env(cfg)
        dynamics_model = create_one_dim_tr_model(
            cfg, env.observation_space.shape, env.action_space.shape, device=device
        )
        model_state = dynamics_model.init(torch.Generator().manual_seed(0))
        model_state = dynamics_model.load(model_state, agent_path)
        model_env = ModelEnv(dynamics_model, term_fn, reward_fn)
        agent_cfg = complete_agent_cfg(env, cfg.algorithm.agent, device=device)
        agent = instantiate(agent_cfg, seed=1)
        agent = create_trajectory_optim_agent_for_model(
            model_env, agent, num_particles=cfg.algorithm.num_particles
        )
        agent.set_eval_state(model_state)
        return agent
    raise ValueError(f"load_agent does not support algorithm {cfg.algorithm.name!r}")
