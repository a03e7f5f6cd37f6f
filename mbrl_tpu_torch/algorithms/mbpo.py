"""MBPO: Model-Based Policy Optimization (Janner et al., 2019); counterpart of
``mbrl_tpu/algorithms/mbpo.py``.

A SAC learner trains on branched imagined rollouts of an ensemble model: the
rollout horizon follows ``truncated_linear``, the SAC buffer's capacity is
recomputed per epoch, update batches may mix real and imagined rows
(``real_data_ratio``), and the agent is evaluated at each epoch's end with a
checkpoint of the best.

What runs where: the host loop steps the real environment and feeds the host
replay buffer; on ``device`` run the ensemble's retraining, the imagined
rollout (per step: a policy action, ``ModelEnv.step`` with ``sample=True``,
which is kernel K3, and a masked write into the device SAC buffer; no host
sync) and each environment step's bundle of SAC updates (batch indices drawn
on the device). A ``parallel`` group other than ``none``, ``num_env_workers >
0`` and ``save_video`` raise ``NotImplementedError``.

The environment is any object with ``observation_space.shape``,
``action_space.{low, high, shape, sample}``, ``reset`` and ``step``; an
evaluation episode ends when the test environment says so (the port's
``util.env.make_env`` caps it at ``trial_length`` steps, as mbrl-lib's
``TimeLimit`` does).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

import mbrl_tpu_torch.constants
from mbrl_tpu_torch.config import Config, create_one_dim_tr_model
from mbrl_tpu_torch.device import DeviceLike, resolve_device
from mbrl_tpu_torch.models import ModelEnv, ModelTrainer
from mbrl_tpu_torch.ops.math import truncated_linear
from mbrl_tpu_torch.planning import RandomAgent
from mbrl_tpu_torch.planning.sac import SAC, SACAgent
from mbrl_tpu_torch.util import checkpoint as ckpt
from mbrl_tpu_torch.util import common as util_common
from mbrl_tpu_torch.util.device_buffer import (
    DeviceBufferState, DeviceReplayBuffer, DeviceTransitionDataset,
)
from mbrl_tpu_torch.util.logger import Logger
from mbrl_tpu_torch.util.runlock import run_lock

MBPO_LOG_FORMAT = mbrl_tpu_torch.constants.EVAL_LOG_FORMAT + [
    ("epoch", "E", "int"),
    ("rollout_length", "RL", "int"),
]


def imagined_rollout(
    model_env: ModelEnv,
    model_state,
    sac: SAC,
    policy: torch.nn.Module,
    sac_buffer: DeviceReplayBuffer,
    buf_state: DeviceBufferState,
    initial_obs: torch.Tensor,
    generator: torch.Generator,
    horizon: int,
    sac_samples_action: bool,
) -> DeviceBufferState:
    """Branched model rollouts from ``initial_obs`` into the device SAC buffer
    (the JAX package's ``_ImaginedRolloutProgram``, mbpo.py:49-106): ``reset``,
    ``prepare_rollout``, then ``horizon`` steps of a policy action (a sample,
    or the mean unless ``sac_samples_action``), ``ModelEnv.step`` with
    ``sample=True`` and a masked write of the rows still alive (``mask = 1 -
    terminated``). ``generator`` lives on the device and drives the model's and
    the policy's draws, so nothing waits for the device."""
    batch = initial_obs.shape[0]
    with torch.no_grad():
        ms = model_env.reset(model_state, initial_obs, generator)
        prepare = getattr(model_env.dynamics_model, "prepare_rollout", None)
        if prepare is not None:
            # every step's TS1 permutation drawn before the loop
            ms = prepare(model_state, ms, horizon, generator)
        obs = initial_obs
        alive = torch.ones((batch,), dtype=torch.bool, device=initial_obs.device)
        for _ in range(horizon):
            action = sac.act_tensor(policy, obs, generator, sample=sac_samples_action)
            next_obs, rewards, terminated, ms = model_env.step(
                model_state, action, ms, generator, sample=True
            )
            terminated = terminated.reshape(batch)
            buf_state = sac_buffer.add_batch_masked(
                buf_state, obs, action, next_obs, rewards.reshape(batch),
                1.0 - terminated.float(), valid=alive,
            )
            alive = alive & ~terminated
            obs = next_obs
    return buf_state


def rollout_model_and_populate_sac_buffer(
    model_env: ModelEnv,
    model_state,
    replay_buffer,
    sac: SAC,
    sac_state,
    sac_buffer: DeviceReplayBuffer,
    sac_buf_state: DeviceBufferState,
    sac_samples_action: bool,
    rollout_horizon: int,
    batch_size: int,
    generator: torch.Generator,
) -> DeviceBufferState:
    """Branched imagined rollouts from ``batch_size`` states sampled from the
    real replay buffer into the device SAC buffer (reference mbpo.py:31-63)."""
    initial_obs = torch.as_tensor(
        replay_buffer.sample(batch_size).obs, dtype=torch.float32, device=sac.device
    )
    return imagined_rollout(
        model_env, model_state, sac, sac_state.policy, sac_buffer, sac_buf_state, initial_obs,
        generator, rollout_horizon, sac_samples_action,
    )


def maybe_replace_sac_buffer(
    sac_buffer: Optional[DeviceReplayBuffer], sac_buf_state, obs_dim: int, act_dim: int,
    new_capacity: int, device: DeviceLike = "cuda",
):
    """The device SAC buffer at a new capacity, keeping its newest rows
    (reference mbpo.py:88-113)."""
    if sac_buffer is None:
        buf = DeviceReplayBuffer(new_capacity, obs_dim, act_dim, device=device)
        return buf, buf.init()
    if sac_buffer.capacity == new_capacity:
        return sac_buffer, sac_buf_state
    return sac_buffer.resize(sac_buf_state, new_capacity)


def evaluate(env, agent: SACAgent, num_episodes: int) -> float:
    """Mean episode reward of the agent's mean actions; an episode ends when
    the environment terminates or truncates it."""
    avg_episode_reward = 0.0
    for _ in range(num_episodes):
        obs, _ = env.reset()
        terminated = truncated = False
        episode_reward = 0.0
        while not terminated and not truncated:
            action = agent.act(obs)
            obs, reward, terminated, truncated, _ = env.step(action)
            episode_reward += reward
        avg_episode_reward += episode_reward
    return avg_episode_reward / num_episodes


def train(
    env,
    test_env,
    termination_fn,
    cfg: Config,
    silent: bool = False,
    work_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> np.float32:
    # one trainer per work dir (util/runlock.py)
    with run_lock(work_dir or os.getcwd()):
        return _train_impl(env, test_env, termination_fn, cfg, silent, work_dir, device)


def _train_impl(
    env,
    test_env,
    termination_fn,
    cfg: Config,
    silent: bool = False,
    work_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> np.float32:
    util_common.reject_unported_parallel(cfg)
    if cfg.get("save_video", False):
        raise NotImplementedError("save_video needs util/video.py, which the port does not have yet")
    device = resolve_device(device)
    debug_mode = cfg.get("debug_mode", False)
    obs_shape = env.observation_space.shape
    act_shape = env.action_space.shape
    obs_dim, act_dim = obs_shape[0], act_shape[0]

    seed = cfg.seed or 0
    rng = np.random.default_rng(seed=cfg.seed)
    # the host generator makes the initial weights; the device ones drive the
    # imagined rollouts and the SAC updates, where a host draw would wait
    generator = torch.Generator().manual_seed(seed)
    rollout_generator = torch.Generator(device=device).manual_seed(seed + 4)
    update_generator = torch.Generator(device=device).manual_seed(seed + 5)

    # ----------------- SAC agent -----------------
    sac = SAC(
        num_inputs=obs_dim,
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
    sac_state = sac.init(generator)
    agent = SACAgent(sac, sac_state, seed=seed + 3,
                     refresh_age=cfg.algorithm.get("actor_refresh_age", 1))

    work_dir = work_dir or os.getcwd()
    logger = None
    if not silent:
        logger = Logger(work_dir, enable_back_compat=True)
        logger.register_group(
            mbrl_tpu_torch.constants.RESULTS_LOG_NAME, MBPO_LOG_FORMAT, color="green"
        )

    # ----------------- model + real buffer -----------------
    dynamics_model = create_one_dim_tr_model(cfg, obs_shape, act_shape, device=device)
    model_state = dynamics_model.init(generator)
    use_double = cfg.algorithm.get("normalize_double_precision", False)
    dtype = np.double if use_double else np.float32
    replay_buffer = util_common.create_replay_buffer(
        cfg, obs_shape, act_shape, rng=rng, obs_type=dtype, action_type=dtype, reward_type=dtype,
    )

    resume_snap = None
    if cfg.get("resume", False):
        latest = ckpt.latest_checkpoint(work_dir)
        if latest is not None:
            resume_snap = ckpt.restore_checkpoint(latest, device=device)
            replay_buffer.load(work_dir)
            print(f"Resuming from {latest}; skipping initial exploration.")
    if resume_snap is None:
        random_explore = cfg.algorithm.random_initial_explore
        util_common.rollout_agent_trajectories(
            env,
            cfg.algorithm.initial_exploration_steps,
            RandomAgent(env) if random_explore else agent,
            {} if random_explore else {"sample": True, "batched": False},
            replay_buffer=replay_buffer,
        )

    model_env = ModelEnv(dynamics_model, termination_fn, None)
    model_trainer = ModelTrainer(
        dynamics_model,
        optim_lr=cfg.overrides.model_lr,
        weight_decay=cfg.overrides.model_wd,
        logger=logger,
    )

    # ----------------- loop -----------------
    # freq_train_model is read from overrides (the interpolation source), so
    # that changes made after loading keep the retraining trigger consistent
    rollout_batch_size = (
        cfg.overrides.effective_model_rollouts_per_step * cfg.overrides.freq_train_model
    )
    trains_per_epoch = int(np.ceil(cfg.overrides.epoch_length / cfg.overrides.freq_train_model))
    updates_made = 0
    env_steps = 0
    best_eval_reward = -np.inf
    epoch = 0
    sac_buffer: Optional[DeviceReplayBuffer] = None
    sac_buf_state = None
    real_snapshot = None  # device copy of the real buffer for mixed batches
    real_ratio = cfg.algorithm.get("real_data_ratio", 0.0)
    sac_batch_size = cfg.overrides.sac_batch_size
    num_sac_updates = cfg.overrides.num_sac_updates_per_step
    checkpoint_every = cfg.get("checkpoint_every", 0)
    # retraining on the device against an incrementally-synced dataset, or
    # through the host iterators (which also save the model and the buffer)
    device_training = cfg.algorithm.get("device_model_training", True)
    device_dataset = (
        DeviceTransitionDataset(obs_dim, act_dim, device=device) if device_training else None
    )
    # a host-side LOWER BOUND on the SAC buffer's row count (the count itself
    # lives on the device and reading it would wait every step): the first
    # step of every imagined rollout writes all `rollout_batch_size` rows, so
    # the bound shows `enough_data` without a read-back
    sac_buf_known_min = 0

    if resume_snap is not None:
        model_state = resume_snap["model_state"]
        sac_state = sac.state_from_host(resume_snap["sac_state"])
        agent.set_state(sac_state)
        gens = resume_snap["generators"]
        for g, name in ((generator, "model"), (rollout_generator, "rollout"),
                        (update_generator, "update"), (agent._generator, "agent")):
            ckpt.set_generator_state(g, gens[name])
        env_steps = int(resume_snap["env_steps"])
        epoch = int(resume_snap["epoch"])
        updates_made = int(resume_snap["updates_made"])
        _ber = resume_snap["best_eval_reward"]
        best_eval_reward = -np.inf if _ber is None else float(_ber)
        print(f"Resumed at env step {env_steps} (epoch {epoch}).")

    def _crosses(freq: int) -> bool:
        return (env_steps + 1) // freq > env_steps // freq

    while env_steps < cfg.overrides.num_steps:
        rollout_length = int(
            truncated_linear(*(list(cfg.overrides.rollout_schedule) + [epoch + 1]))
        )
        sac_buffer_capacity = (
            rollout_length * rollout_batch_size * trains_per_epoch
            * cfg.overrides.num_epochs_to_retain_sac_buffer
        )
        if sac_buffer is None or sac_buffer.capacity != sac_buffer_capacity:
            sac_buffer, sac_buf_state = maybe_replace_sac_buffer(
                sac_buffer, sac_buf_state, obs_dim, act_dim, sac_buffer_capacity, device
            )
            sac_buf_known_min = min(sac_buf_known_min, sac_buffer.capacity)

        obs = None
        terminated = truncated = False
        steps_epoch = 0
        while steps_epoch < cfg.overrides.epoch_length:
            if steps_epoch == 0 or terminated or truncated:
                obs, _ = env.reset()
                terminated = truncated = False
            next_obs, reward, terminated, truncated, _ = util_common.step_env_and_add_to_buffer(
                env, obs, agent, {"sample": True}, replay_buffer
            )

            # --------------- model training + imagined rollouts ---------------
            if _crosses(cfg.overrides.freq_train_model):
                if device_training:
                    model_state = dynamics_model.update_normalizer_host(
                        model_state, replay_buffer.get_all()
                    )
                    device_dataset.sync_from(replay_buffer)
                    model_state, _, _ = model_trainer.train_device(
                        model_state,
                        device_dataset,
                        batch_size=cfg.overrides.model_batch_size,
                        val_ratio=cfg.overrides.validation_ratio,
                        num_epochs=cfg.overrides.get("num_epochs_train_model", None),
                        patience=cfg.overrides.get("patience", 1),
                        improvement_threshold=cfg.overrides.get("improvement_threshold", 0.01),
                    )
                else:
                    model_state = util_common.train_model_and_save_model_and_data(
                        dynamics_model, model_state, model_trainer,
                        cfg.overrides, replay_buffer, work_dir=work_dir,
                    )
                sac_buf_state = rollout_model_and_populate_sac_buffer(
                    model_env, model_state, replay_buffer, sac, sac_state, sac_buffer,
                    sac_buf_state, cfg.algorithm.sac_samples_action, rollout_length,
                    rollout_batch_size, rollout_generator,
                )
                sac_buf_known_min = min(sac_buffer.capacity, sac_buf_known_min + rollout_batch_size)
                if real_ratio > 0:
                    all_real = replay_buffer.get_all()

                    def dev(x, shape=None):
                        t = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
                        return t if shape is None else t.reshape(shape)

                    real_snapshot = (
                        dev(all_real.obs), dev(all_real.act), dev(all_real.next_obs),
                        dev(all_real.rewards, (-1, 1)),
                        1.0 - dev(all_real.terminateds, (-1, 1)),
                    )
                if checkpoint_every and _crosses(checkpoint_every):
                    ckpt.save_checkpoint(
                        work_dir,
                        {
                            "model_state": model_state,
                            "sac_state": sac.state_to_host(sac_state),
                            "generators": {
                                "model": ckpt.generator_state(generator),
                                "rollout": ckpt.generator_state(rollout_generator),
                                "update": ckpt.generator_state(update_generator),
                                "agent": ckpt.generator_state(agent._generator),
                            },
                            "env_steps": env_steps,
                            "epoch": epoch,
                            "updates_made": updates_made,
                            # None before the first evaluation: the
                            # NaN-refusing validator must not mistake the
                            # -inf sentinel for divergence
                            "best_eval_reward": (
                                float(best_eval_reward) if np.isfinite(best_eval_reward) else None
                            ),
                        },
                        step=env_steps,
                    )
                    if device_training:
                        # the host route saves at every retraining; here the
                        # model and the buffer ride the checkpoint cadence
                        dynamics_model.save(model_state, str(work_dir))
                        replay_buffer.save(work_dir)
                if debug_mode:
                    print(
                        f"Epoch: {epoch}. SAC buffer: {int(sac_buf_state.num_stored)}. "
                        f"Rollout length: {rollout_length}. Steps: {env_steps}"
                    )

            # --------------- SAC updates ---------------
            enough_data = sac_buf_known_min >= sac_batch_size
            upd_freq = cfg.overrides.sac_updates_every_steps
            if num_sac_updates > 0 and enough_data and _crosses(upd_freq):
                if real_ratio > 0 and real_snapshot is not None:
                    g = update_generator
                    batches = sac_buffer.sample_many(sac_buf_state, g, num_sac_updates,
                                                     sac_batch_size)
                    n_real = real_snapshot[0].shape[0]
                    ridx = torch.randint(0, n_real, (num_sac_updates, sac_batch_size),
                                         generator=g, device=device)
                    use_real = torch.rand((num_sac_updates,), generator=g, device=device) < real_ratio
                    sel = use_real[:, None, None]
                    batches = tuple(torch.where(sel, arr[ridx], ib)
                                    for arr, ib in zip(real_snapshot, batches))
                    sac_state, _ = sac.update_many(sac_state, batches, g)
                else:
                    sac_state, _ = sac.update_from_buffer(
                        sac_state, sac_buf_state, update_generator,
                        num_updates=num_sac_updates, batch_size=sac_batch_size,
                    )
                agent.set_state(sac_state)
                updates_made += num_sac_updates
                if logger is not None and updates_made % cfg.log_frequency_agent < num_sac_updates:
                    logger.dump(updates_made, save=True)

            # --------------- epoch end: evaluate + checkpoint ---------------
            if _crosses(cfg.overrides.epoch_length):
                avg_reward = evaluate(test_env, agent, cfg.algorithm.num_eval_episodes)
                if logger is not None:
                    logger.log_data(
                        mbrl_tpu_torch.constants.RESULTS_LOG_NAME,
                        {
                            "epoch": epoch,
                            "env_step": env_steps,
                            "episode_reward": avg_reward,
                            "rollout_length": rollout_length,
                        },
                    )
                if avg_reward > best_eval_reward:
                    best_eval_reward = avg_reward
                    sac.save_checkpoint(sac_state, os.path.join(work_dir, "sac.pkl"))
                epoch += 1

            env_steps += 1
            steps_epoch += 1
            obs = next_obs
    return np.float32(best_eval_reward)
