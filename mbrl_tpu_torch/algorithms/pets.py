"""PETS: Probabilistic Ensembles with Trajectory Sampling (Chua et al., 2018);
counterpart of ``mbrl_tpu/algorithms/pets.py``.

Seed the buffer with random exploration, then loop: retrain the ensemble every
``freq_train_model`` env steps, and act via CEM/iCEM/MPPI MPC over the learned
model's imagined rollouts. Returns the maximum episode reward observed.

The host loop steps the real environment and feeds the replay buffer; planning
and model training run on ``device``. The agent's objective reads the model
wrapper STATE, refreshed via ``set_eval_state`` after each retraining.

With ``parallel=mesh`` the planning particles and the training rows split
over the ranks of a process group (``parallel/``); with
``overrides.num_env_workers`` > 0 a pool of worker processes steps that many
environments, each planned for by ``act(batched=True)``.

The environment is any object with ``observation_space.shape``,
``action_space.{low, high, shape, sample}``, ``reset`` and ``step`` (a
``gymnasium`` environment is one such); ``termination_fn`` and ``reward_fn``
take and return tensors.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

import mbrl_tpu_torch.constants
from mbrl_tpu_torch.config import Config, complete_agent_cfg, create_one_dim_tr_model, instantiate
from mbrl_tpu_torch.device import DeviceLike, resolve_device
from mbrl_tpu_torch.models import ModelEnv, ModelTrainer
from mbrl_tpu_torch.parallel import distributed_collect, make_parallel_context
from mbrl_tpu_torch.planning import RandomAgent, create_trajectory_optim_agent_for_model
from mbrl_tpu_torch.util import checkpoint as ckpt
from mbrl_tpu_torch.util import common as util_common
from mbrl_tpu_torch.util.device_buffer import DeviceTransitionDataset
from mbrl_tpu_torch.util.logger import Logger
from mbrl_tpu_torch.util.runlock import run_lock

EVAL_LOG_FORMAT = mbrl_tpu_torch.constants.EVAL_LOG_FORMAT


def train(
    env,
    termination_fn,
    reward_fn,
    cfg: Config,
    silent: bool = False,
    work_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> np.float32:
    # one trainer per work dir: a second concurrent process would interleave
    # checkpoints/results rows from a diverging lineage (util/runlock.py)
    with run_lock(work_dir or os.getcwd()):
        return _train_impl(env, termination_fn, reward_fn, cfg, silent, work_dir, device)


def _train_impl(
    env,
    termination_fn,
    reward_fn,
    cfg: Config,
    silent: bool = False,
    work_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> np.float32:
    device = resolve_device(device)
    debug_mode = cfg.get("debug_mode", False)

    obs_shape = env.observation_space.shape
    act_shape = env.action_space.shape

    rng = np.random.default_rng(seed=cfg.seed)
    generator = torch.Generator().manual_seed(cfg.seed or 0)

    work_dir = work_dir or os.getcwd()
    logger = None
    if not silent:
        print(f"Results will be saved at {work_dir}.")
        logger = Logger(work_dir)
        logger.register_group(
            mbrl_tpu_torch.constants.RESULTS_LOG_NAME, EVAL_LOG_FORMAT, color="green"
        )

    # -------- Create and populate initial env dataset --------
    dynamics_model = create_one_dim_tr_model(cfg, obs_shape, act_shape, device=device)
    model_state = dynamics_model.init(generator)
    use_double_dtype = cfg.algorithm.get("normalize_double_precision", False)
    dtype = np.double if use_double_dtype else np.float32
    replay_buffer = util_common.create_replay_buffer(
        cfg,
        obs_shape,
        act_shape,
        rng=rng,
        obs_type=dtype,
        action_type=dtype,
        reward_type=dtype,
    )
    resume_snap = None
    if cfg.get("resume", False):
        latest = ckpt.latest_checkpoint(work_dir)
        if latest is not None:
            resume_snap = ckpt.restore_checkpoint(latest, device=device)
            replay_buffer.load(work_dir)
            print(f"Resuming from {latest}; skipping initial exploration.")
    if resume_snap is None:
        util_common.rollout_agent_trajectories(
            env,
            cfg.algorithm.initial_exploration_steps,
            RandomAgent(env),
            {},
            replay_buffer=replay_buffer,
        )
        replay_buffer.save(work_dir)

    # ---------- Create model environment and agent -----------
    # optional mesh from the `parallel:` config group: planning particles and
    # training rows over the data axis, members over the model axis inside a
    # retraining; the model state stays whole on every rank between them
    pctx = make_parallel_context(cfg)
    model_env = ModelEnv(
        dynamics_model,
        termination_fn,
        reward_fn,
        particle_sharding=pctx.particle_sharding() if pctx else None,
    )
    model_trainer = ModelTrainer(
        dynamics_model,
        optim_lr=cfg.overrides.model_lr,
        weight_decay=cfg.overrides.model_wd,
        logger=logger,
        parallel_ctx=pctx,
    )
    agent_cfg = complete_agent_cfg(env, cfg.algorithm.agent, device=device)
    agent = instantiate(agent_cfg, seed=(cfg.seed or 0) + 1)
    agent = create_trajectory_optim_agent_for_model(
        model_env, agent, num_particles=cfg.algorithm.num_particles
    )
    agent.set_eval_state(model_state)
    # `algorithm.planning_prng_impl` picks a JAX key implementation; a
    # torch.Generator has no such choice, so the setting is ignored.

    # Device-resident model retraining (ModelTrainer.train_device) against an
    # incrementally-synced device dataset; the host-iterator path re-uploads
    # the growing buffer every epoch.
    device_training = cfg.algorithm.get("device_model_training", True)
    device_dataset = None
    if device_training:
        device_dataset = DeviceTransitionDataset(obs_shape[0], act_shape[0], device=device)

    def retrain_model(model_state):
        if not device_training:
            return util_common.train_model_and_save_model_and_data(
                dynamics_model, model_state, model_trainer,
                cfg.overrides, replay_buffer, work_dir=work_dir,
            )
        model_state = dynamics_model.update_normalizer_host(
            model_state, replay_buffer.get_all()
        )
        device_dataset.sync_from(replay_buffer)
        if pctx is not None:
            pctx.shard_dataset(device_dataset)
        model_state, _, _ = model_trainer.train_device(
            model_state,
            device_dataset,
            batch_size=cfg.overrides.model_batch_size,
            val_ratio=cfg.overrides.validation_ratio,
            num_epochs=cfg.overrides.get("num_epochs_train_model", None),
            patience=cfg.overrides.get("patience", 1),
            improvement_threshold=cfg.overrides.get("improvement_threshold", 0.01),
        )
        dynamics_model.save(model_state, str(work_dir))
        replay_buffer.save(work_dir)
        return model_state

    # optional batched collection: this process's slice of the worker pool,
    # each step planned for every local worker by act(batched=True); the
    # settings a pool cannot run with are refused before a worker starts
    distributed_collect.check_pool_width(cfg, cfg.algorithm.freq_train_model)

    # --------------------- Training Loop ---------------------
    env_steps = 0
    current_trial = 0
    max_total_reward = -np.inf

    # mid-run resume: restore model/planner state + counters from the newest
    # checkpoint in the work dir
    if resume_snap is not None:
        model_state = resume_snap["model_state"]
        ckpt.set_generator_state(generator, resume_snap["generators"]["model"])
        ckpt.set_generator_state(agent._generator, resume_snap["generators"]["agent"])
        env_steps = int(resume_snap["env_steps"])
        current_trial = int(resume_snap["current_trial"])
        _mtr = resume_snap["max_total_reward"]
        max_total_reward = -np.inf if _mtr is None else float(_mtr)
        agent.set_eval_state(model_state)
        print(f"Resumed at env step {env_steps}.")
    checkpoint_every = cfg.get("checkpoint_every", 0)

    def checkpoint():
        ckpt.save_checkpoint(
            work_dir,
            {
                "model_state": model_state,
                "generators": {
                    "model": ckpt.generator_state(generator),
                    "agent": ckpt.generator_state(agent._generator),
                },
                "env_steps": env_steps,
                "current_trial": current_trial,
                # None while no episode has finished: the NaN-refusing
                # validator must not mistake the -inf sentinel for divergence
                "max_total_reward": (
                    float(max_total_reward) if np.isfinite(max_total_reward) else None
                ),
            },
            step=env_steps,
        )

    collector = distributed_collect.maybe_make_collector(cfg, seed=(cfg.seed or 0) + 100)
    if collector is not None:
        # ---------------- batched worker-pool collection ----------------
        # W trials side by side; retraining on cadence crossings of the
        # GLOBAL env_steps (every process's workers), so budgets and cadences
        # do not depend on the process count
        try:
            w = collector.num_local_workers
            wg = collector.num_workers_total
            freq = cfg.algorithm.freq_train_model
            # the batched loop truncates trials at trial_length too: the
            # shipped configs' environments never end an episode themselves
            trial_length = int(cfg.overrides.get("trial_length", 0) or 0)
            rewards_acc = np.zeros(w)
            steps_in_trial = np.zeros(w, np.int64)
            dones_mask = np.ones(w, bool)  # everyone plans anew on the first step
            while env_steps < cfg.overrides.num_steps:
                if env_steps == 0 or env_steps // freq != (env_steps + wg) // freq:
                    model_state = retrain_model(model_state)
                    agent.set_eval_state(model_state)
                # checkpoint crossings are independent of retrain crossings
                if checkpoint_every and env_steps and (
                    env_steps // checkpoint_every != (env_steps + wg) // checkpoint_every
                ):
                    checkpoint()
                actions = agent.act(collector.current_obs, batched=True, reset_mask=dones_mask)
                obs_b, next_b, rew_b, term_b, trunc_b = collector.step(actions)
                steps_in_trial += 1
                if trial_length:
                    timeout = (steps_in_trial >= trial_length) & ~(term_b | trunc_b)
                    if timeout.any():
                        trunc_b = trunc_b | timeout
                        collector.reset_workers(np.flatnonzero(timeout))
                replay_buffer.add_batch(obs_b, actions, next_b, rew_b, term_b, trunc_b)
                rewards_acc += rew_b
                dones_mask = term_b | trunc_b
                steps_in_trial[dones_mask] = 0
                for i in np.flatnonzero(dones_mask):
                    total_reward = float(rewards_acc[i])
                    rewards_acc[i] = 0.0
                    current_trial += 1
                    max_total_reward = max(max_total_reward, total_reward)
                    if logger is not None:
                        logger.log_data(
                            mbrl_tpu_torch.constants.RESULTS_LOG_NAME,
                            {"env_step": env_steps, "episode_reward": total_reward},
                        )
                env_steps += wg
        finally:
            collector.close()
        return np.float32(max_total_reward)

    while env_steps < cfg.overrides.num_steps:
        obs, _ = env.reset()
        agent.reset()
        terminated = False
        truncated = False
        total_reward = 0.0
        steps_trial = 0
        while not terminated and not truncated:
            if env_steps % cfg.algorithm.freq_train_model == 0:
                model_state = retrain_model(model_state)
                agent.set_eval_state(model_state)
            # checkpoint cadence is independent of the retrain cadence
            if checkpoint_every and env_steps and env_steps % checkpoint_every == 0:
                checkpoint()

            next_obs, reward, terminated, truncated, _ = (
                util_common.step_env_and_add_to_buffer(
                    env, obs, agent, {}, replay_buffer
                )
            )
            obs = next_obs
            total_reward += reward
            steps_trial += 1
            env_steps += 1
            if cfg.overrides.get("trial_length", None) and steps_trial >= cfg.overrides.trial_length:
                truncated = True
            if debug_mode:
                print(f"Step {env_steps}: Reward {reward:.3f}.")
        if logger is not None:
            logger.log_data(
                mbrl_tpu_torch.constants.RESULTS_LOG_NAME,
                {"env_step": env_steps, "episode_reward": total_reward},
            )
        current_trial += 1
        if debug_mode:
            print(f"Trial: {current_trial}, reward: {total_reward}.")
        max_total_reward = max(max_total_reward, total_reward)

    return np.float32(max_total_reward)
