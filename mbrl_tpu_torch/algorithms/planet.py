"""PlaNet training loop (Hafner et al., 2019); counterpart of
``mbrl_tpu/algorithms/planet.py``.

Collect random initial trajectories, then per episode: train the RSSM for
``num_grad_updates`` sequence batches (B=50, L=50 in the paper config), save it,
and collect one episode acting with CEM in latent space, updating the model's
posterior each real step and adding exploration noise except on test episodes.
Returns the mean episode reward.

On ``device``: the RSSM's training (``ModelTrainer.train_device_sequences``,
windows gathered from a device mirror of the uint8 replay buffer; or the host
sequence iterator with ``algorithm.device_model_training: false``), the
posterior updates and the latent planning (``ModelEnv``'s per-step loop over
``PlaNetModel.sample``). The host steps the environment and keeps the buffer.

The environment is any object with ``observation_space.shape`` (C, H, W),
``action_space.{low, high, shape, dtype, sample}``, ``reset`` and ``step``
(``util.dmcontrol_wrapper.DmControlEnv`` is one; a ``gymnasium`` environment
is another).
"""
from __future__ import annotations

import os
import pathlib
import time
from typing import List, Optional, Union

import numpy as np
import torch

import mbrl_tpu_torch.constants
from mbrl_tpu_torch.config import Config, complete_agent_cfg, instantiate
from mbrl_tpu_torch.device import DeviceLike, resolve_device
from mbrl_tpu_torch.envs.termination_fns import no_termination
from mbrl_tpu_torch.models import ModelEnv, ModelTrainer
from mbrl_tpu_torch.parallel import make_parallel_context, replicate
from mbrl_tpu_torch.planning import RandomAgent, create_trajectory_optim_agent_for_model
from mbrl_tpu_torch.util import checkpoint as ckpt
from mbrl_tpu_torch.util import common as util_common
from mbrl_tpu_torch.util.device_buffer import DeviceTransitionDataset
from mbrl_tpu_torch.util.logger import Logger
from mbrl_tpu_torch.util.runlock import run_lock

METRICS_LOG_FORMAT = [
    ("observations_loss", "OL", "float"),
    ("reward_loss", "RL", "float"),
    ("gradient_norm", "GN", "float"),
    ("kl_loss", "KL", "float"),
]


def train(
    env,
    cfg: Config,
    silent: bool = False,
    work_dir: Union[Optional[str], pathlib.Path] = None,
    device: DeviceLike = "cuda",
) -> np.float32:
    # one trainer per work dir (util/runlock.py)
    with run_lock(work_dir if work_dir is not None else os.getcwd()):
        return _train_impl(env, cfg, silent, work_dir, device)


def valid_window_starts(trajectory_indices, seq_len: int) -> np.ndarray:
    """Row ids at which a window of ``seq_len`` rows fits inside one stored
    trajectory."""
    starts = [np.arange(lo, hi - seq_len + 1, dtype=np.int64)
              for lo, hi in (trajectory_indices or []) if hi - lo >= seq_len]
    return np.concatenate(starts) if starts else np.zeros((0,), np.int64)


def _train_impl(env, cfg: Config, silent: bool, work_dir, device: DeviceLike) -> np.float32:
    device = resolve_device(device)
    debug_mode = cfg.get("debug_mode", False)
    work_dir = pathlib.Path(work_dir if work_dir is not None else os.getcwd())

    logger = None
    if not silent:
        print(f"Results will be saved at {work_dir}.")
        logger = Logger(work_dir)
        logger.register_group("metrics", METRICS_LOG_FORMAT, color="yellow")
        logger.register_group(
            mbrl_tpu_torch.constants.RESULTS_LOG_NAME,
            [
                ("env_step", "S", "int"),
                ("train_episode_reward", "RT", "float"),
                ("episode_reward", "ET", "float"),
            ],
            color="green",
        )

    generator = torch.Generator().manual_seed(cfg.seed or 0)
    np_rng = np.random.default_rng(seed=cfg.seed)
    obs_shape = env.observation_space.shape
    pixels = len(obs_shape) == 3

    # replay buffer with trajectory tracking + initial random data
    replay_buffer = util_common.create_replay_buffer(
        cfg,
        obs_shape,
        env.action_space.shape,
        obs_type=np.uint8 if pixels else np.float32,
        collect_trajectories=True,
        rng=np_rng,
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
            cfg.algorithm.num_initial_trajectories,
            RandomAgent(env),
            agent_kwargs={},
            replay_buffer=replay_buffer,
            collect_full_trajectories=True,
            trial_length=cfg.overrides.trial_length,
            agent_uses_low_dim_obs=False,
        )

    # PlaNet model, model env, trainer, latent-space CEM agent
    cfg.dynamics_model["action_size"] = env.action_space.shape[0]
    planet = instantiate(cfg.dynamics_model, device=device)
    planet_state = planet.init(generator)
    # optional mesh (`parallel=mesh`; give the data axis every rank with
    # parallel.model_axis_size=1): the RSSM is whole on every rank, each
    # rank trains on its block of every batch's windows
    pctx = make_parallel_context(cfg)
    if pctx is not None:
        planet_state = {**planet_state, "params": replicate(planet_state["params"], pctx.mesh)}
    model_env = ModelEnv(
        planet, no_termination, None,
        particle_sharding=pctx.particle_sharding() if pctx else None,
    )
    trainer = ModelTrainer(planet, logger=logger, optim_lr=1e-3, optim_eps=1e-4,
                           parallel_ctx=pctx)
    agent_cfg = complete_agent_cfg(env, cfg.algorithm.agent, device=device)
    agent = instantiate(agent_cfg, seed=(cfg.seed or 0) + 1)
    agent = create_trajectory_optim_agent_for_model(model_env, agent)
    agent.set_eval_state(planet_state)

    # metric accumulation via the trainer's batch callback
    rec_losses: List[float] = []
    reward_losses: List[float] = []
    kl_losses: List[float] = []
    grad_norms: List[float] = []

    def batch_callback(_epoch, _loss, meta, _mode):
        if meta:
            rec_losses.append(float(meta["observations_loss"]))
            reward_losses.append(float(meta["reward_loss"]))
            kl_losses.append(float(meta["kl_loss"]))
            grad_norms.append(float(meta.get("grad_norm", 0.0)))

    def is_test_episode(episode):
        return episode % cfg.algorithm.test_frequency == 0

    # RSSM training on the device: a device mirror of the uint8 pixel buffer
    # with windows gathered there; the host route stacks all num_grad_updates
    # (B, L, C, H, W) batches of an episode first (~12 GB at the paper config)
    device_training = cfg.algorithm.get("device_model_training", True)
    device_dataset = None
    if device_training:
        device_dataset = DeviceTransitionDataset(
            obs_shape, env.action_space.shape[0],
            obs_dtype=torch.uint8 if pixels else torch.float32, device=device,
        )

    step = replay_buffer.num_stored
    total_rewards = 0.0
    start_episode = 0
    if resume_snap is not None:
        planet_state = resume_snap["planet_state"]
        ckpt.set_generator_state(generator, resume_snap["generators"]["model"])
        ckpt.set_generator_state(agent._generator, resume_snap["generators"]["agent"])
        start_episode = int(resume_snap["episode"])
        step = int(resume_snap["step"])
        total_rewards = float(resume_snap["total_rewards"])
        agent.set_eval_state(planet_state)
        print(f"Resumed at episode {start_episode} (env step {step}).")
    checkpoint_every = int(cfg.get("checkpoint_every", 0))
    trial_length = cfg.overrides.get("trial_length", None)
    for episode in range(start_episode, cfg.algorithm.num_episodes):
        # --------------- train the RSSM ---------------
        if device_training:
            device_dataset.sync_from(replay_buffer)
            if pctx is not None:
                pctx.shard_dataset(device_dataset)
            planet_state, _ = trainer.train_device_sequences(
                planet_state,
                device_dataset,
                valid_window_starts(replay_buffer.trajectory_indices,
                                    cfg.overrides.sequence_length),
                num_updates=cfg.overrides.num_grad_updates,
                batch_size=cfg.overrides.batch_size,
                seq_len=cfg.overrides.sequence_length,
                generator=generator,
                batch_callback=batch_callback,
            )
        else:
            dataset, _ = util_common.get_sequence_buffer_iterator(
                replay_buffer,
                cfg.overrides.batch_size,
                0,  # no validation data
                cfg.overrides.sequence_length,
                max_batches_per_loop_train=cfg.overrides.num_grad_updates,
                use_simple_sampler=True,
            )
            planet_state, _, _ = trainer.train(
                planet_state, dataset, num_epochs=1, batch_callback=batch_callback,
                evaluate=False, generator=generator,
            )
        agent.set_eval_state(planet_state)
        if not silent:
            print(f"episode {episode}: RSSM trained", flush=True)
        planet.save(planet_state, work_dir)
        if cfg.overrides.get("save_replay_buffer", False):
            replay_buffer.save(work_dir)
        if logger is not None:
            logger.log_data(
                "metrics",
                {
                    "observations_loss": float(np.mean(rec_losses)) if rec_losses else 0,
                    "reward_loss": float(np.mean(reward_losses)) if reward_losses else 0,
                    "gradient_norm": float(np.mean(grad_norms)) if grad_norms else 0,
                    "kl_loss": float(np.mean(kl_losses)) if kl_losses else 0,
                },
            )
        for c in (rec_losses, reward_losses, kl_losses, grad_norms):
            c.clear()

        # --------------- collect one episode ---------------
        episode_reward = 0.0
        episode_t0 = time.time()
        obs, _ = env.reset()
        agent.reset()
        planet_state = planet.reset_posterior(planet_state)
        action = None
        terminated = truncated = False
        steps_in_trial = 0
        while not terminated and not truncated:
            planet_state = planet.update_posterior(planet_state, obs, action=action,
                                                   generator=generator)
            agent.set_eval_state(planet_state)
            action_noise = (
                0
                if is_test_episode(episode)
                else cfg.algorithm.action_noise_std
                * np_rng.standard_normal(env.action_space.shape[0])
            )
            action = agent.act(obs) + action_noise
            action = np.clip(action, -1.0, 1.0).astype(env.action_space.dtype)
            next_obs, reward, terminated, truncated, _ = env.step(action)
            # a trial-length truncation is stored WITH the transition, so that
            # the trajectory-tracking buffer closes the segment
            if trial_length and steps_in_trial + 1 >= trial_length:
                truncated = True
            replay_buffer.add(obs, action, next_obs, reward, terminated, truncated)
            episode_reward += reward
            obs = next_obs
            if debug_mode:
                print(f"step: {step}, reward: {reward}.")
            step += 1
            steps_in_trial += 1
        total_rewards += episode_reward
        if not silent:
            print(f"episode {episode}: reward {episode_reward:.1f} "
                  f"({time.time() - episode_t0:.1f}s, step {step})", flush=True)
        if logger is not None:
            logger.log_data(
                mbrl_tpu_torch.constants.RESULTS_LOG_NAME,
                {
                    "episode_reward": episode_reward * is_test_episode(episode),
                    "train_episode_reward": episode_reward * (1 - is_test_episode(episode)),
                    "env_step": step,
                },
            )
        if checkpoint_every and (episode + 1) % checkpoint_every == 0:
            ckpt.save_checkpoint(
                work_dir,
                {
                    "planet_state": planet_state,
                    "generators": {
                        "model": ckpt.generator_state(generator),
                        "agent": ckpt.generator_state(agent._generator),
                    },
                    "episode": episode + 1,
                    "step": step,
                    "total_rewards": total_rewards,
                },
                step=episode + 1,
            )
            replay_buffer.save(work_dir)

    return np.float32(total_rewards / cfg.algorithm.num_episodes)
