"""The port's PETS tutorial (``mbrl_tpu_torch/examples/tutorial_pets.py``) at a
small size on the CPU: the CEM population cut from 350 to 50, ``num_steps``
from 2,000 to 60 and ``trial_length`` from 200 to 50, with the environment,
its random exploration and the replay buffer seeded (the tutorial leaves them
to the OS's entropy, as the JAX package's does). Its model and planner keep
the tutorial's widths (5 x 3x128 silu, 20 particles, horizon 15).

The threshold: after 200 random steps (cartpole episodes of 9-40 steps), the
planned episodes keep the pole up for at least 40 of the 50 steps allowed.
"""
import numpy as np
import pytest
import torch

from mbrl_tpu_torch.examples import tutorial_pets

POPULATION, NUM_STEPS, TRIAL_LENGTH, THRESHOLD = 50, 60, 50, 40.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the test workers share the
    CPU, and a pool of threads per worker over small products slows them all
    many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_pets_tutorial_balances_the_pole(monkeypatch, capsys):
    cem, env_cls, buffer_cls = (tutorial_pets.CEMOptimizer, tutorial_pets.CartPoleEnv,
                                tutorial_pets.ReplayBuffer)

    def seeded_env():
        env = env_cls()
        env.np_random = np.random.default_rng(0)
        env.action_space.seed(0)
        return env

    monkeypatch.setattr(tutorial_pets, "CEMOptimizer",
                        lambda **kw: cem(**{**kw, "population_size": POPULATION}))
    monkeypatch.setattr(tutorial_pets, "CartPoleEnv", seeded_env)
    monkeypatch.setattr(tutorial_pets, "ReplayBuffer",
                        lambda *a, **kw: buffer_cls(*a, rng=np.random.default_rng(0), **kw))
    best = tutorial_pets.main(num_steps=NUM_STEPS, trial_length=TRIAL_LENGTH, device="cpu")
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("steps")]
    assert lines and all("episode reward" in line for line in lines)
    assert best >= THRESHOLD, lines
