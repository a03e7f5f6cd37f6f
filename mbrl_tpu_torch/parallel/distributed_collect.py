"""Multi-process real-environment collection (counterpart of
``mbrl_tpu/parallel/distributed_collect.py``): each process owns a slice of
the global worker pool and collects into its own replay buffer.

The topology is share-nothing on the collection side: process p steps the
workers ``local_worker_slice(W)`` and writes their transitions into its own
buffer. With one process it is a plain batched worker pool, which acts for W
environments per agent call.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from mbrl_tpu_torch.parallel.env_workers import EnvWorkerPool
from mbrl_tpu_torch.parallel.multihost import local_worker_slice, process_info


class DistributedCollector:
    """This process's share of a ``num_workers_total``-wide worker pool.

    Worker seeds come from the GLOBAL worker id, so the same total pool makes
    the same environment streams however many processes share it.
    """

    def __init__(self, env_ctor: Callable, num_workers_total: int, seed: int = 0):
        self.num_workers_total = num_workers_total
        self.worker_ids = local_worker_slice(num_workers_total)
        if len(self.worker_ids) == 0:
            raise ValueError(
                f"process {process_info()[0]} got 0 of {num_workers_total} env "
                "workers; use at least one worker per process"
            )
        self.pool = EnvWorkerPool(
            env_ctor, len(self.worker_ids), seed=seed + self.worker_ids.start
        )

    @property
    def num_local_workers(self) -> int:
        return self.pool.num_workers

    @property
    def current_obs(self) -> np.ndarray:
        return self.pool.current_obs

    def step(self, actions: np.ndarray):
        return self.pool.step(actions)

    def reset_workers(self, indices, seed=None):
        return self.pool.reset_workers(indices, seed=seed)

    def collect(
        self,
        agent,
        num_steps: int,
        replay_buffer=None,
        sample: bool = True,
    ) -> List[float]:
        """``num_steps`` batched steps into the local buffer; returns the
        rewards of the episodes that ended (local workers only)."""
        return self.pool.collect(
            agent, num_steps, replay_buffer=replay_buffer, sample=sample
        )

    def collect_random(self, action_space, num_steps: int, replay_buffer=None):
        """Seed data with uniform random actions (the random exploration phase,
        batched over the local workers)."""
        return self.pool.collect(
            _RandomBatchAgent(action_space, self.pool.num_workers),
            num_steps,
            replay_buffer=replay_buffer,
        )

    def close(self) -> None:
        self.pool.close()


class _RandomBatchAgent:
    """One uniform sample of ``space`` per local worker."""

    def __init__(self, space, n: int):
        self.space = space
        self.n = n

    def act(self, obs, sample=True, batched=True):
        return np.stack([self.space.sample() for _ in range(self.n)])


class _ConfigEnvCtor:
    """Top-level picklable environment constructor: forkserver/spawn workers
    receive this object (the config rides along via ``Config.__getstate__``)
    and build the environment inside the child."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self):
        from mbrl_tpu_torch.util.env import create_handler

        env, *_ = create_handler(self.cfg).make_env(self.cfg)
        return env


def make_env_ctor(cfg):
    """Picklable environment constructor from a config (the algorithms' own
    factory, ``util/env.py``)."""
    return _ConfigEnvCtor(cfg)


def check_pool_width(cfg, freq_train_model: int) -> int:
    """``overrides.num_env_workers``, refused before a worker starts when the
    pool is wider than the retraining cadence (one batched step would cross
    it more than once), or when ``parallel=mesh`` spans more than one process:
    each process's workers fill its own buffer, while the mesh trains one
    model on rows every rank must hold alike and plans for the same
    observations on every rank."""
    width = int(cfg.overrides.get("num_env_workers", 0) or 0)
    if width > freq_train_model:
        raise ValueError(
            f"num_env_workers={width} exceeds freq_train_model={freq_train_model}: one "
            "batched step would cross the retrain cadence more than once; lower the pool width"
        )
    pcfg = cfg.get("parallel", None) if hasattr(cfg, "get") else None
    sharded = pcfg is not None and pcfg.get("enable", False) and (
        pcfg.get("shard_particles", True) or pcfg.get("shard_training", True))
    if width > 0 and sharded and process_info()[1] > 1:
        raise ValueError(
            f"num_env_workers={width} with parallel=mesh over {process_info()[1]} processes: "
            "each process's workers would fill a buffer of its own, and the mesh needs the "
            "same rows and observations on every rank; use one of the two"
        )
    return width


def maybe_make_collector(cfg, seed: int = 0) -> Optional[DistributedCollector]:
    """This process's collector iff ``overrides.num_env_workers`` > 0."""
    num_workers = int(cfg.overrides.get("num_env_workers", 0) or 0)
    if num_workers <= 0:
        return None
    return DistributedCollector(make_env_ctor(cfg), num_workers, seed=seed)
