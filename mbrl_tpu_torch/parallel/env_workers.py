"""Parallel real-environment workers feeding the learner (counterpart of
``mbrl_tpu/parallel/env_workers.py``).

A pool of persistent worker processes, each owning one environment instance,
stepped in lockstep with BATCHED agent actions, so a SAC or MPC agent acts for
W environments per call. The learner owns the card; a worker steps a host
simulator and never initialises CUDA: it hides the cards from itself before
it builds its environment, and builds it from a picklable constructor (a
top-level class or function) inside the child.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import sys
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def _worker_loop(remote, env_ctor, seed: int):
    # the learner owns the card: hide it before anything here could touch it
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    env = env_ctor()
    obs, _ = env.reset(seed=seed)
    remote.send(obs)
    while True:
        cmd, data = remote.recv()
        if cmd == "step":
            obs, reward, terminated, truncated, _ = env.step(data)
            if terminated or truncated:
                final_obs = obs
                obs, _ = env.reset()
                remote.send((final_obs, reward, terminated, truncated, obs))
            else:
                remote.send((obs, reward, terminated, truncated, None))
        elif cmd == "reset":
            obs, _ = env.reset(seed=data)
            remote.send(obs)
        elif cmd == "info":
            torch = sys.modules.get("torch")
            remote.send({
                "pid": os.getpid(),
                "cuda_initialized": bool(torch is not None and torch.cuda.is_initialized()),
                "packages": sorted({name.split(".")[0] for name in sys.modules}),
            })
        elif cmd == "close":
            remote.close()
            break


class EnvWorkerPool:
    """W persistent environment processes stepped with batched actions.

    ``step(actions (W, A))`` returns ``(obs_before, next_obs, rewards,
    terminateds, truncateds)``; episodes auto-reset, with the pre-reset
    terminal observation reported for correct transition storage.
    """

    def __init__(self, env_ctor: Callable, num_workers: int, seed: int = 0):
        # forkserver (spawn fallback): never fork the learner, whose CUDA and
        # threads a forked child would inherit; env_ctor must be picklable
        try:
            ctx = mp.get_context("forkserver")
        except ValueError:  # pragma: no cover - non-POSIX fallback
            ctx = mp.get_context("spawn")
        self.num_workers = num_workers
        self._remotes = []
        self._procs = []
        for w in range(num_workers):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_worker_loop, args=(child, env_ctor, seed + w), daemon=True
            )
            proc.start()
            child.close()
            self._remotes.append(parent)
            self._procs.append(proc)
        self.current_obs = np.stack([r.recv() for r in self._remotes])

    def step(self, actions: np.ndarray):
        """Batched step; returns transitions with auto-reset bookkeeping.

        Returns (obs_before, next_obs, rewards, terminateds, truncateds); the
        pool's ``current_obs`` advances to the (possibly reset) next observations.
        """
        for remote, action in zip(self._remotes, actions):
            remote.send(("step", np.asarray(action)))
        obs_before = self.current_obs
        next_obs = np.empty_like(self.current_obs)
        after_reset = np.empty_like(self.current_obs)
        rewards = np.empty(self.num_workers)
        terminateds = np.empty(self.num_workers, bool)
        truncateds = np.empty(self.num_workers, bool)
        for i, remote in enumerate(self._remotes):
            ob, r, te, tr, reset_ob = remote.recv()
            next_obs[i] = ob
            rewards[i] = r
            terminateds[i] = te
            truncateds[i] = tr
            after_reset[i] = reset_ob if reset_ob is not None else ob
        self.current_obs = after_reset
        return obs_before, next_obs, rewards, terminateds, truncateds

    def collect(
        self,
        agent,
        num_steps: int,
        replay_buffer=None,
        sample: bool = True,
    ) -> List[float]:
        """Collect ``num_steps`` batched steps with an agent that supports batched
        acting (e.g. SACAgent); optionally store all transitions. Returns the
        rewards of the episodes that ended."""
        rewards_sum = np.zeros(self.num_workers)
        episode_rewards: List[float] = []
        for _ in range(num_steps):
            actions = agent.act(self.current_obs, sample=sample, batched=True)
            actions = np.atleast_2d(np.asarray(actions))
            obs, next_obs, rewards, terminateds, truncateds = self.step(actions)
            if replay_buffer is not None:
                replay_buffer.add_batch(
                    obs, actions, next_obs, rewards, terminateds, truncateds
                )
            rewards_sum += rewards
            for i in range(self.num_workers):
                if terminateds[i] or truncateds[i]:
                    episode_rewards.append(float(rewards_sum[i]))
                    rewards_sum[i] = 0.0
        return episode_rewards

    def reset_workers(self, indices, seed: Optional[int] = None) -> np.ndarray:
        """Reset only the given workers (e.g. the batched PETS loop's
        ``trial_length`` truncation); the others keep their episodes."""
        indices = np.asarray(indices, int).ravel()
        for i in indices:
            self._remotes[i].send(("reset", None if seed is None else seed + int(i)))
        for i in indices:
            self.current_obs[i] = self._remotes[i].recv()
        return self.current_obs

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        for i, remote in enumerate(self._remotes):
            remote.send(("reset", None if seed is None else seed + i))
        self.current_obs = np.stack([r.recv() for r in self._remotes])
        return self.current_obs

    def worker_info(self) -> List[Dict[str, Any]]:
        """Each worker's pid, whether it initialised CUDA, and the top-level
        packages it imported."""
        for remote in self._remotes:
            remote.send(("info", None))
        return [remote.recv() for remote in self._remotes]

    def close(self) -> None:
        for remote in self._remotes:
            try:
                remote.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
