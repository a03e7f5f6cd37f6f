"""Config-driven object factories (counterpart of ``mbrl_tpu/config/factories.py``):
auto in/out sizing from env shapes, BasicEnsemble member special-casing,
obs-process fn lookup by dotted name, action-bound completion for planner
agents. Every object built here takes the ``device`` it is given (default
``"cuda"``).
"""
from __future__ import annotations

import pathlib
from typing import Optional, Tuple, Union

import numpy as np

from mbrl_tpu_torch.config.engine import Config, _import_target, instantiate, to_dict
from mbrl_tpu_torch.device import DeviceLike


def create_one_dim_tr_model(
    cfg: Config,
    obs_shape: Tuple[int, ...],
    act_shape: Tuple[int, ...],
    model_dir: Optional[Union[str, pathlib.Path]] = None,
    device: DeviceLike = "cuda",
):
    """Instantiate the dynamics model from cfg.dynamics_model on ``device`` and
    wrap it in a TransitionRewardModel. Returns the wrapper (state is created by
    the caller via ``wrapper.init(generator)`` / loaded from ``model_dir``)."""
    from mbrl_tpu_torch.models import BasicEnsemble, TransitionRewardModel

    model_cfg = cfg.dynamics_model
    target = _import_target(model_cfg["_target_"])
    basic = isinstance(target, type) and issubclass(target, BasicEnsemble)
    size_cfg = model_cfg.member_cfg if basic else model_cfg
    if size_cfg.get("in_size", None) in (None, "???"):
        size_cfg["in_size"] = obs_shape[0] + (act_shape[0] if act_shape else 1)
    if size_cfg.get("out_size", None) in (None, "???"):
        size_cfg["out_size"] = obs_shape[0] + int(cfg.algorithm.learned_rewards)

    if basic:
        # the member takes the device; the ensemble is wherever its member is
        ensemble_cfg = to_dict(model_cfg)
        member = instantiate(ensemble_cfg.pop("member_cfg"), device=device)
        model = instantiate(ensemble_cfg, member_model=member)
    else:
        model = instantiate(model_cfg, device=device)

    name_obs_process_fn = cfg.overrides.get("obs_process_fn", None)
    obs_process_fn = _import_target(name_obs_process_fn) if name_obs_process_fn else None

    no_delta = cfg.overrides.get("no_delta_list", None)
    wrapper = TransitionRewardModel(
        model,
        target_is_delta=cfg.algorithm.target_is_delta,
        normalize=cfg.algorithm.normalize,
        normalize_double_precision=cfg.algorithm.get("normalize_double_precision", False),
        learned_rewards=cfg.algorithm.learned_rewards,
        obs_process_fn=obs_process_fn,
        no_delta_list=list(no_delta) if no_delta else None,
        num_elites=cfg.overrides.get("num_elites", None),
    )
    return wrapper


def complete_agent_cfg(env, agent_cfg: Config, device: Optional[DeviceLike] = None) -> Config:
    """Fill env-derived mandatory fields (action bounds, obs/act dims) into an agent
    config node, and the planner optimizer's ``device`` when one is given."""
    obs_shape = env.observation_space.shape
    act_shape = env.action_space.shape

    def setq(key, value):
        if key in agent_cfg and agent_cfg._data.get(key) == "???":
            agent_cfg[key] = value
        elif key in agent_cfg._data and agent_cfg._data[key] == "???":
            agent_cfg[key] = value

    if "action_lb" in agent_cfg:
        setq("action_lb", np.asarray(env.action_space.low).tolist())
    if "action_ub" in agent_cfg:
        setq("action_ub", np.asarray(env.action_space.high).tolist())
    if "obs_dim" in agent_cfg:
        setq("obs_dim", obs_shape[0])
    if "act_dim" in agent_cfg:
        setq("act_dim", act_shape[0])
    if "num_inputs" in agent_cfg:
        setq("num_inputs", obs_shape[0])

    # planner optimizer bounds tiled over the horizon
    opt_cfg = agent_cfg.get("optimizer", None)
    if opt_cfg is not None and "lower_bound" in opt_cfg:
        horizon = agent_cfg.get("planning_horizon", 1)
        lb = np.tile(np.asarray(env.action_space.low, np.float64), (horizon, 1))
        ub = np.tile(np.asarray(env.action_space.high, np.float64), (horizon, 1))
        if opt_cfg._data.get("lower_bound") in (None, "???"):
            opt_cfg["lower_bound"] = lb.tolist()
            agent_cfg["optimizer"] = opt_cfg
        if opt_cfg._data.get("upper_bound") in (None, "???"):
            opt_cfg["upper_bound"] = ub.tolist()
            agent_cfg["optimizer"] = opt_cfg
    if opt_cfg is not None and device is not None:
        opt_cfg["device"] = str(device)
        agent_cfg["optimizer"] = opt_cfg
    return agent_cfg


def create_agent(env, agent_cfg: Config, device: DeviceLike = "cuda"):
    """Complete an agent config against an env and instantiate it."""
    agent_cfg = complete_agent_cfg(env, agent_cfg, device=device)
    return instantiate(agent_cfg)
