"""Buffer and iterator builders, and environment rollout helpers (counterpart
of ``mbrl_tpu/util/common.py``). Model and agent creation from config lives in
``mbrl_tpu_torch.config``. Nothing here needs ``gymnasium``: an environment is
any object with ``reset``, ``step`` and the two spaces.
"""
from __future__ import annotations

import pathlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from mbrl_tpu_torch.util.replay_buffer import (
    BootstrapIterator,
    ReplayBuffer,
    SequenceTransitionIterator,
    SequenceTransitionSampler,
    TransitionIterator,
)


def create_replay_buffer(
    cfg,
    obs_shape: Sequence[int],
    act_shape: Sequence[int],
    obs_type=np.float32,
    action_type=np.float32,
    reward_type=np.float32,
    load_dir: Optional[Union[str, pathlib.Path]] = None,
    collect_trajectories: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> ReplayBuffer:
    """Build a replay buffer from config (capacity from overrides.trial_length *
    overrides.num_trials via dataset_size, or num_steps; trajectory mode requires
    trial_length)."""
    dataset_size = cfg.algorithm.get("dataset_size", None)
    if not dataset_size:
        dataset_size = cfg.overrides.num_steps
    maybe_max_trajectory_len = None
    if collect_trajectories:
        if cfg.overrides.get("trial_length", None) is None:
            raise ValueError(
                "cfg.overrides.trial_length must be set when "
                "collect_trajectories==True."
            )
        maybe_max_trajectory_len = cfg.overrides.trial_length

    replay_buffer = ReplayBuffer(
        dataset_size,
        obs_shape,
        act_shape,
        obs_type=obs_type,
        action_type=action_type,
        reward_type=reward_type,
        rng=rng,
        max_trajectory_length=maybe_max_trajectory_len,
    )
    if load_dir:
        replay_buffer.load(str(load_dir))
    return replay_buffer


def get_basic_buffer_iterators(
    replay_buffer: ReplayBuffer,
    batch_size: int,
    val_ratio: float,
    ensemble_size: int = 1,
    shuffle_each_epoch: bool = True,
    bootstrap_permutes: bool = False,
) -> Tuple[BootstrapIterator, Optional[TransitionIterator]]:
    """Shuffled train/val split; train is bootstrapped per ensemble member."""
    data = replay_buffer.get_all(shuffle=True)
    val_size = int(replay_buffer.num_stored * val_ratio)
    train_size = replay_buffer.num_stored - val_size
    train_data = data[:train_size]
    train_iter = BootstrapIterator(
        train_data,
        batch_size,
        ensemble_size,
        shuffle_each_epoch=shuffle_each_epoch,
        permute_indices=bootstrap_permutes,
        rng=replay_buffer.rng,
    )
    val_iter = None
    if val_size > 0:
        val_data = data[train_size:]
        val_iter = TransitionIterator(
            val_data, batch_size, shuffle_each_epoch=False, rng=replay_buffer.rng
        )
    return train_iter, val_iter


def get_sequence_buffer_iterator(
    replay_buffer: ReplayBuffer,
    batch_size: int,
    val_ratio: float,
    sequence_length: int,
    ensemble_size: int = 1,
    shuffle_each_epoch: bool = True,
    max_batches_per_loop_train: Optional[int] = None,
    max_batches_per_loop_val: Optional[int] = None,
    use_simple_sampler: bool = False,
):
    """Trajectory-wise train/val split of sequence windows."""
    assert replay_buffer.stores_trajectories, (
        "The passed replay buffer does not store trajectory information. "
        "Make sure that the replay buffer is created with the max_trajectory_length "
        "parameter set."
    )
    transitions = replay_buffer.get_all()
    num_trajectories = len(replay_buffer.trajectory_indices)
    val_size = int(num_trajectories * val_ratio)
    train_size = num_trajectories - val_size
    all_trajectories = replay_buffer.rng.permutation(num_trajectories)
    train_trajectories = [
        tuple(replay_buffer.trajectory_indices[i]) for i in all_trajectories[:train_size]
    ]

    if use_simple_sampler:
        train_iterator: Any = SequenceTransitionSampler(
            transitions,
            train_trajectories,
            batch_size,
            sequence_length,
            max_batches_per_loop_train,
            rng=replay_buffer.rng,
        )
    else:
        train_iterator = SequenceTransitionIterator(
            transitions,
            train_trajectories,
            batch_size,
            sequence_length,
            ensemble_size,
            shuffle_each_epoch=shuffle_each_epoch,
            rng=replay_buffer.rng,
            max_batches_per_loop=max_batches_per_loop_train,
        )

    val_iterator = None
    if val_size > 0:
        val_trajectories = [
            tuple(replay_buffer.trajectory_indices[i])
            for i in all_trajectories[train_size:]
        ]
        if use_simple_sampler:
            val_iterator = SequenceTransitionSampler(
                transitions,
                val_trajectories,
                batch_size,
                sequence_length,
                max_batches_per_loop_val,
                rng=replay_buffer.rng,
            )
        else:
            val_iterator = SequenceTransitionIterator(
                transitions,
                val_trajectories,
                batch_size,
                sequence_length,
                1,
                shuffle_each_epoch=shuffle_each_epoch,
                rng=replay_buffer.rng,
                max_batches_per_loop=max_batches_per_loop_val,
            )
            val_iterator.toggle_bootstrap()

    return train_iterator, val_iterator


def train_model_and_save_model_and_data(
    model,
    model_state: Dict[str, Any],
    model_trainer,
    cfg,
    replay_buffer: ReplayBuffer,
    work_dir: Optional[Union[str, pathlib.Path]] = None,
    callback: Optional[Callable] = None,
) -> Dict[str, Any]:
    """Update normalizer from the full buffer, train with early stopping, optionally
    save model + buffer; returns the updated model state."""
    dataset_train, dataset_val = get_basic_buffer_iterators(
        replay_buffer,
        cfg.model_batch_size,
        cfg.validation_ratio,
        ensemble_size=len(model),
        shuffle_each_epoch=True,
        bootstrap_permutes=cfg.get("bootstrap_permutes", False),
    )
    model_state = model.update_normalizer(model_state, replay_buffer.get_all())
    model_state, _, _ = model_trainer.train(
        model_state,
        dataset_train,
        dataset_val=dataset_val,
        num_epochs=cfg.get("num_epochs_train_model", None),
        patience=cfg.get("patience", 1),
        improvement_threshold=cfg.get("improvement_threshold", 0.01),
        callback=callback,
    )
    if work_dir is not None:
        model.save(model_state, str(work_dir))
        replay_buffer.save(work_dir)
    return model_state


def rollout_agent_trajectories(
    env,
    steps_or_trials_to_collect: int,
    agent,
    agent_kwargs: Dict,
    trial_length: Optional[int] = None,
    callback: Optional[Callable] = None,
    replay_buffer: Optional[ReplayBuffer] = None,
    collect_full_trajectories: bool = False,
    agent_uses_low_dim_obs: bool = False,
    seed: Optional[int] = None,
) -> List[float]:
    """Collect env transitions with an agent; steps-mode or full-trials-mode."""
    if (
        replay_buffer is not None
        and replay_buffer.stores_trajectories
        and not collect_full_trajectories
    ):
        raise RuntimeError(
            "Replay buffer is tracking trajectory information but "
            "collect_trajectories is set to False, which will result in "
            "corrupted trajectory data."
        )

    step = 0
    trial = 0
    total_rewards: List[float] = []
    while True:
        obs, _ = env.reset(seed=seed)
        seed = None  # only seed the first reset
        agent.reset()
        terminated = False
        truncated = False
        total_reward = 0.0
        while not terminated and not truncated:
            if replay_buffer is not None:
                next_obs, reward, terminated, truncated, _ = step_env_and_add_to_buffer(
                    env,
                    obs,
                    agent,
                    agent_kwargs,
                    replay_buffer,
                    callback=callback,
                    agent_uses_low_dim_obs=agent_uses_low_dim_obs,
                )
            else:
                if agent_uses_low_dim_obs:
                    raise RuntimeError(
                        "Option agent_uses_low_dim_obs is only valid if a "
                        "replay buffer is given."
                    )
                action = agent.act(obs, **agent_kwargs)
                next_obs, reward, terminated, truncated, _ = env.step(action)
                if callback:
                    callback((obs, action, next_obs, reward, terminated, truncated))
            obs = next_obs
            total_reward += reward
            step += 1
            if not collect_full_trajectories and step == steps_or_trials_to_collect:
                total_rewards.append(total_reward)
                return total_rewards
            if trial_length and step % trial_length == 0:
                if (
                    collect_full_trajectories
                    and not (terminated or truncated)
                    and replay_buffer is not None
                ):
                    replay_buffer.close_trajectory()
                break
        trial += 1
        total_rewards.append(total_reward)
        if collect_full_trajectories and trial == steps_or_trials_to_collect:
            break
    return total_rewards


def step_env_and_add_to_buffer(
    env,
    obs: np.ndarray,
    agent,
    agent_kwargs: Dict,
    replay_buffer: ReplayBuffer,
    callback: Optional[Callable] = None,
    agent_uses_low_dim_obs: bool = False,
) -> Tuple[np.ndarray, float, bool, bool, Dict]:
    """One env step through the agent, stored in the buffer."""
    if agent_uses_low_dim_obs and not hasattr(env, "get_last_low_dim_obs"):
        raise RuntimeError(
            "Option agent_uses_low_dim_obs is only compatible with "
            "env that has get_last_low_dim_obs (a pixel wrapper)."
        )
    if agent_uses_low_dim_obs:
        agent_obs = getattr(env, "get_last_low_dim_obs")()
    else:
        agent_obs = obs
    action = agent.act(agent_obs, **agent_kwargs)
    next_obs, reward, terminated, truncated, info = env.step(action)
    replay_buffer.add(obs, action, next_obs, reward, terminated, truncated)
    if callback:
        callback((obs, action, next_obs, reward, terminated, truncated))
    return next_obs, reward, terminated, truncated, info


def rollout_model_env(
    model_env,
    model_wrapper_state: Dict[str, Any],
    initial_obs: np.ndarray,
    generator,
    plan: Optional[np.ndarray] = None,
    agent=None,
    num_samples: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Roll a plan (or an agent's plan) inside the model env for diagnostics.
    Returns (obs_history, rewards, plan)."""
    import torch

    obs_history = []
    reward_history = []
    if agent:
        plan = agent.plan(initial_obs)
    obs0 = torch.as_tensor(np.asarray(initial_obs), dtype=torch.float32).expand(
        (num_samples,) + tuple(np.shape(initial_obs))
    )
    with torch.no_grad():
        model_state = model_env.reset(model_wrapper_state, obs0, generator)
        obs_history.append(obs0.numpy().copy())
        for action in plan:
            actions = torch.as_tensor(np.asarray(action), dtype=torch.float32).expand(
                (num_samples,) + tuple(np.shape(action))
            )
            next_obs, rewards, terminated, model_state = model_env.step(
                model_wrapper_state, actions, model_state, generator, sample=True
            )
            obs_history.append(next_obs.cpu().numpy())
            reward_history.append(rewards.cpu().numpy())
    return np.stack(obs_history), np.stack(reward_history), np.asarray(plan)
