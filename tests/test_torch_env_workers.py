"""The port's env worker pool, distributed collector and batched PETS and
MBPO loops (``mbrl_tpu_torch/parallel/env_workers.py``,
``distributed_collect.py``) against the JAX package's (CPU).

The pools step seeded environments with actions from a seeded
``np.random.default_rng``; observations, rewards and flags agree to 1e-6. The
constructors handed to a pool are top-level classes, which ``forkserver``
pickles by reference; every agent draws from a seeded generator."""
import csv
import pathlib

import numpy as np
import pytest
import torch

from mbrl_tpu.envs.cartpole_continuous import CartPoleEnv as JaxCartPoleEnv
from mbrl_tpu.parallel import multihost as jax_multihost
from mbrl_tpu.parallel.env_workers import EnvWorkerPool as JaxEnvWorkerPool
import mbrl_tpu_torch.algorithms.mbpo as mbpo
import mbrl_tpu_torch.algorithms.pets as pets
from mbrl_tpu_torch.config import load_config
from mbrl_tpu_torch.envs.cartpole_continuous import CartPoleEnv
from mbrl_tpu_torch.parallel import distributed_collect, multihost
from mbrl_tpu_torch.parallel.distributed_collect import DistributedCollector
from mbrl_tpu_torch.parallel.env_workers import EnvWorkerPool
from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

_CONF_DIR = pathlib.Path(__file__).parent.parent / "mbrl_tpu_torch" / "examples" / "conf"
ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the test workers share the
    CPU, and a pool of threads per worker over small products slows them all
    many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class LineEnv:
    """A point mass on a line pushed by the action; the episode ends after 30
    steps (the MockLineEnv of tests/test_torch_pets.py, with its own spaces)."""

    def __init__(self, horizon: int = 30):
        from mbrl_tpu_torch.envs.spaces import Box

        self.horizon = horizon
        self.observation_space = Box(-np.inf * np.ones(2), np.inf * np.ones(2), shape=(2,),
                                     dtype=np.float64, seed=0)
        self.action_space = Box(-np.ones(1), np.ones(1), shape=(1,), dtype=np.float64, seed=0)

    def reset(self, seed=None, options=None):
        self.pos, self.vel, self.time_left = 1.0, 0.0, self.horizon
        return np.array([self.pos, self.vel]), {}

    def step(self, action):
        self.vel += float(np.asarray(action).reshape(-1)[0])
        self.pos += self.vel
        self.time_left -= 1
        return (np.array([self.pos, self.vel]), -1e-3 * self.pos ** 2, self.time_left == 0,
                False, {})


class NoTermLineEnv(LineEnv):
    """A LineEnv that never ends an episode itself: only ``trial_length``
    truncation in the batched PETS loop ends one."""

    def step(self, action):
        obs, reward, _, _, info = super().step(action)
        return obs, reward, False, False, info


def line_term_fn(act, next_obs):
    return torch.zeros((next_obs.shape[0], 1), dtype=torch.bool, device=next_obs.device)


def line_reward_fn(act, next_obs):
    return (-1e-3 * next_obs[:, 0] ** 2)[:, None]


# --------------------------------------------------------------------------- #
# The pool against the JAX pool
# --------------------------------------------------------------------------- #
def _drive(pool, steps: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        actions = rng.uniform(-1, 1, (pool.num_workers, 1)).astype(np.float32)
        out.append(tuple(np.asarray(x, np.float64) for x in pool.step(actions)))
        out.append((np.asarray(pool.current_obs, np.float64),))
    return out


def test_pool_steps_the_cartpole_as_the_jax_pool():
    """Four cartpoles, seeded alike, driven by the same seeded actions for 60
    steps (episodes end and auto-reset on the way): every observation, reward
    and flag agrees, the terminal observations too."""
    ours, theirs = EnvWorkerPool(CartPoleEnv, 4, seed=3), JaxEnvWorkerPool(JaxCartPoleEnv, 4, seed=3)
    try:
        np.testing.assert_allclose(ours.current_obs, theirs.current_obs, rtol=0, atol=ATOL)
        a, b = _drive(ours, 60), _drive(theirs, 60)
        dones = 0
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                np.testing.assert_allclose(u, v, rtol=0, atol=ATOL)
            if len(x) == 5:
                dones += int(((x[3] + x[4]) > 0).sum())
        assert dones > 0  # the auto-reset was exercised
    finally:
        ours.close()
        theirs.close()


def test_pool_reports_the_terminal_observation_and_resets_only_the_workers_asked():
    pool = EnvWorkerPool(LineEnv, 3, seed=0)
    try:
        for t in range(30):
            obs, next_obs, rewards, terms, truncs = pool.step(np.full((3, 1), 0.5))
        # the 30th step ends every episode: the terminal observation comes back,
        # the pool's current observation is the reset one
        assert terms.all() and not truncs.any()
        assert np.allclose(next_obs[:, 1], 15.0) and np.allclose(pool.current_obs, [[1.0, 0.0]] * 3)
        pool.step(np.full((3, 1), 1.0))
        moved = pool.current_obs.copy()
        obs = pool.reset_workers([1])
        assert np.allclose(obs[1], [1.0, 0.0])
        assert np.allclose(obs[[0, 2]], moved[[0, 2]]) and not np.allclose(moved[1], [1.0, 0.0])
        info = pool.worker_info()
        assert len({i["pid"] for i in info}) == 3
        assert not any(i["cuda_initialized"] for i in info)
    finally:
        pool.close()


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_local_worker_slice_matches_the_jax_partition(rank, world, monkeypatch):
    monkeypatch.setattr(multihost, "process_info", lambda: (rank, world))
    monkeypatch.setattr(jax_multihost, "process_info", lambda: (rank, world))
    for n in (3, 4, 5, 7):
        assert multihost.local_worker_slice(n) == jax_multihost.local_worker_slice(n)
    # the ranks' slices partition [0, n)
    slices = []
    for r in range(world):
        monkeypatch.setattr(multihost, "process_info", lambda r=r: (r, world))
        slices += list(multihost.local_worker_slice(5))
    assert slices == list(range(5))


def test_distributed_collector_collects_random_rows():
    col = DistributedCollector(LineEnv, num_workers_total=3, seed=5)
    try:
        assert col.num_local_workers == 3 and list(col.worker_ids) == [0, 1, 2]
        buf = ReplayBuffer(128, (2,), (1,), rng=np.random.default_rng(0))
        env = LineEnv()
        env.action_space.seed(0)
        col.collect_random(env.action_space, 10, replay_buffer=buf)
        assert buf.num_stored == 30  # 10 batched steps x 3 workers
        batch = buf.get_all()
        assert np.isfinite(batch.obs).all()
        # next_obs = dynamics(obs, act) row by row, in the buffer's float32
        np.testing.assert_allclose(batch.next_obs[:, 1], batch.obs[:, 1] + batch.act[:, 0],
                                   rtol=1e-6, atol=1e-6)
    finally:
        col.close()


# --------------------------------------------------------------------------- #
# The batched loops
# --------------------------------------------------------------------------- #
def _pets_cfg(*extra):
    return load_config(_CONF_DIR, "main", overrides=[
        "algorithm=pets", "overrides=pets_cartpole",
        "overrides.env=mock", "overrides.num_env_workers=2",
        "overrides.num_steps=80", "overrides.trial_length=20",
        "algorithm.initial_exploration_steps=40",
        "algorithm.freq_train_model=40",
        "overrides.num_epochs_train_model=2",
        "overrides.model_batch_size=16",
        "overrides.cem_population_size=32", "overrides.cem_num_iters=2",
        "overrides.planning_horizon=4", "algorithm.num_particles=8",
        "dynamics_model.ensemble_size=2", "dynamics_model.hid_size=32",
        "dynamics_model.num_layers=2", "seed=0", *extra,
    ])


def test_pets_with_env_workers(tmp_path, monkeypatch):
    """80 steps over a pool of two: a retraining at 0 and before each step
    that crosses a multiple of 40 (38 -> 40, 78 -> 80), every step planned for
    both workers (act(batched=True)), and the episodes that trial_length 20
    ends, two a worker, logged."""
    monkeypatch.setattr(distributed_collect, "make_env_ctor", lambda cfg: LineEnv)
    cfg = _pets_cfg()
    best = pets.train(LineEnv(), line_term_fn, line_reward_fn, cfg, silent=False,
                      work_dir=str(tmp_path), device="cpu")
    assert np.isfinite(float(best))
    with open(tmp_path / "model_train.csv") as f:
        iterations = {row["train_iteration"] for row in csv.DictReader(f)}
    assert iterations == {"0", "1", "2"}
    with open(tmp_path / "results.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 4 and all(np.isfinite(float(r["episode_reward"])) for r in rows)


def test_pets_batched_trial_length_truncation(tmp_path, monkeypatch):
    """With environments that never end an episode, the batched loop ends
    them at trial_length, resets those workers and logs the rewards: 60 steps
    over two workers at trial_length 10 are 3 x 2 episodes."""
    monkeypatch.setattr(distributed_collect, "make_env_ctor", lambda cfg: NoTermLineEnv)
    cfg = load_config(_CONF_DIR, "main", overrides=[
        "algorithm=pets", "overrides=pets_cartpole",
        "overrides.env=mock", "overrides.num_env_workers=2",
        "overrides.num_steps=60", "overrides.trial_length=10",
        "algorithm.initial_exploration_steps=30",
        "algorithm.freq_train_model=30",
        "overrides.num_epochs_train_model=1",
        "overrides.model_batch_size=16",
        "overrides.cem_population_size=16", "overrides.cem_num_iters=2",
        "overrides.planning_horizon=3", "algorithm.num_particles=4",
        "dynamics_model.ensemble_size=2", "dynamics_model.hid_size=16",
        "dynamics_model.num_layers=2", "seed=0",
    ])
    best = pets.train(NoTermLineEnv(), line_term_fn, line_reward_fn, cfg, silent=False,
                      work_dir=str(tmp_path), device="cpu")
    assert np.isfinite(float(best))
    with open(tmp_path / "results.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["env_step"]) for r in rows] == [18, 18, 38, 38, 58, 58]


def test_mbpo_with_env_workers(tmp_path, monkeypatch):
    """MBPO over a pool of two: random exploration over the pool, one
    SACAgent.act(batched=True) per step, the cadences crossed by steps of 2."""
    monkeypatch.setattr(distributed_collect, "make_env_ctor", lambda cfg: LineEnv)
    cfg = load_config(_CONF_DIR, "main", overrides=[
        "algorithm=mbpo", "overrides=mbpo_halfcheetah",
        "overrides.env=mock", "overrides.num_env_workers=2",
        "overrides.num_steps=120", "overrides.epoch_length=60",
        "overrides.freq_train_model=30", "overrides.patience=1",
        "overrides.effective_model_rollouts_per_step=2",
        "overrides.rollout_schedule=[1,15,1,1]",
        "overrides.num_sac_updates_per_step=4",
        "overrides.sac_updates_every_steps=2",
        "dynamics_model.ensemble_size=2", "dynamics_model.num_layers=2",
        "dynamics_model.hid_size=32", "algorithm.initial_exploration_steps=64",
        "overrides.num_epochs_train_model=2", "overrides.model_batch_size=16",
        "overrides.sac_batch_size=32", "algorithm.num_eval_episodes=1", "seed=0",
    ])
    best = mbpo.train(LineEnv(), LineEnv(), line_term_fn, cfg, silent=False,
                      work_dir=str(tmp_path), device="cpu")
    assert np.isfinite(float(best))
    with open(tmp_path / "results.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1]  # two epochs of 60 steps
    with open(tmp_path / "model_train.csv") as f:
        assert {row["train_iteration"] for row in csv.DictReader(f)} == {"0", "1", "2", "3"}


@pytest.mark.parametrize("algorithm", ["pets", "mbpo"])
def test_batched_pool_wider_than_cadence_rejected(algorithm, tmp_path, monkeypatch):
    """num_env_workers > freq_train_model raises before any worker starts."""
    def no_pool(*a, **kw):
        raise AssertionError("a worker pool was started")

    monkeypatch.setattr(distributed_collect, "EnvWorkerPool", no_pool)
    if algorithm == "pets":
        cfg = _pets_cfg("overrides.num_env_workers=4", "algorithm.freq_train_model=2",
                        "algorithm.initial_exploration_steps=10")
        with pytest.raises(ValueError, match="freq_train_model"):
            pets.train(LineEnv(), line_term_fn, line_reward_fn, cfg, silent=True,
                       work_dir=str(tmp_path), device="cpu")
    else:
        cfg = load_config(_CONF_DIR, "main", overrides=[
            "algorithm=mbpo", "overrides=mbpo_halfcheetah", "overrides.num_env_workers=4",
            "overrides.freq_train_model=2", "seed=0"])
        with pytest.raises(ValueError, match="freq_train_model"):
            mbpo.train(LineEnv(), LineEnv(), line_term_fn, cfg, silent=True,
                       work_dir=str(tmp_path), device="cpu")
