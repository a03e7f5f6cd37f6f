"""``ClosedLoopDriver`` of the port on the CPU: tests/test_closed_loop.py's
three cases, the driver against a hand-written loop of ``optimize`` and
``ModelEnv.step`` (equal to 0.0), and the final state of the toy integrator
against mbrl_tpu's driver, statistically (the random streams differ)."""
import importlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbrl_tpu.planning import CEMOptimizer as JaxCEM
from mbrl_tpu.planning import ClosedLoopDriver as JaxDriver
from mbrl_tpu_torch.models import BasicEnsemble, GaussianMLP, ModelEnv, TransitionRewardModel
from mbrl_tpu_torch.planning import CEMOptimizer, ClosedLoopDriver, ICEMOptimizer, MPPIOptimizer

REPO = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        return importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(REPO))

OBS_DIM, ACT_DIM, HORIZON = 2, 1, 4


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _no_term(act, next_obs):
    return torch.zeros((next_obs.shape[0], 1), dtype=torch.bool)


def _bounds(horizon=HORIZON):
    return dict(lower_bound=np.tile([-1.0], (horizon, 1)).tolist(),
                upper_bound=np.tile([1.0], (horizon, 1)).tolist())


def _cem(population=32):
    return CEMOptimizer(num_iterations=2, elite_ratio=0.2, population_size=population, alpha=0.1,
                        return_mean_elites=True, device="cpu", **_bounds())


def _integrator_model():
    """tests/test_closed_loop.py's hand-set model: zero weights but act into
    the first hidden unit, a dead head, logvar ~ -20: next obs ~ obs."""
    model = GaussianMLP(OBS_DIM + ACT_DIM, OBS_DIM, num_layers=1, ensemble_size=2, hid_size=4,
                        propagation_method="fixed_model", device="cpu")
    params = model.init(_gen(0))
    params["layers"][0]["w"] = torch.zeros((2, OBS_DIM + ACT_DIM, 4))
    params["layers"][0]["w"][:, OBS_DIM, 0] = 10.0
    params["layers"][0]["b"] = torch.zeros((2, 1, 4))
    params["head"] = {"w": torch.zeros((2, 4, 2 * OBS_DIM)), "b": torch.zeros((2, 1, 2 * OBS_DIM))}
    params["min_logvar"] = -20.0 * torch.ones((1, OBS_DIM))
    params["max_logvar"] = -19.0 * torch.ones((1, OBS_DIM))
    wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=False,
                                    learned_rewards=False)
    return wrapper, {"params": params, "normalizer": None}


def test_closed_loop_driver_runs_and_accumulates():
    wrapper, state = _integrator_model()
    env = ModelEnv(wrapper, _no_term, lambda act, next_obs: -(next_obs[:, :1] ** 2))
    driver = ClosedLoopDriver(env, _cem(), horizon=HORIZON, act_dim=ACT_DIM, num_particles=2,
                              sample_env_step=False)
    obs0 = np.array([0.5, 0.0], np.float32)
    obs_traj, actions, rewards, terms = driver.run(state, obs0, _gen(0), num_steps=6)
    assert obs_traj.shape == (6, OBS_DIM) and actions.shape == (6, ACT_DIM)
    assert rewards.shape == (6,) and terms.shape == (6,) and terms.dtype == torch.bool
    assert bool(torch.isfinite(rewards).all())
    np.testing.assert_allclose(obs_traj[0].numpy(), obs0, atol=1e-5)
    assert np.all(np.abs(obs_traj.numpy() - obs0) < 0.1)


def test_closed_loop_pads_the_act_rows_to_the_elites_with_learned_rewards():
    model = GaussianMLP(OBS_DIM + ACT_DIM, OBS_DIM + 1, num_layers=2, ensemble_size=3, hid_size=8,
                        propagation_method="random_model", device="cpu")
    wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=False,
                                    learned_rewards=True)
    state = {"params": model.init(_gen(1)), "normalizer": None}
    env = ModelEnv(wrapper, _no_term, None)
    driver = ClosedLoopDriver(env, _cem(30), HORIZON, ACT_DIM, num_particles=3)
    assert driver._act_rows(state) == 3
    obs_traj, actions, rewards, _ = driver.run(state, np.zeros(OBS_DIM, np.float32), _gen(2),
                                               num_steps=4)
    assert obs_traj.shape == (4, OBS_DIM) and rewards.shape == (4,)
    assert bool(torch.isfinite(obs_traj).all())
    # two elites: two rows
    assert driver._act_rows({"params": model.set_elite(state["params"], [0, 2])}) == 2


class ToyEnv:
    """s' = s + 0.2 a, reward -(s' - 1)^2: the optimum is s = 1."""

    class DM:
        model = None

    dynamics_model = DM()

    def reset(self, st, obs_rows, generator):
        return {"s": obs_rows}

    def step(self, st, action, env_state, generator, sample=True):
        s = env_state["s"] + 0.2 * action
        r = -torch.square(s - 1.0).sum(dim=-1, keepdim=True)
        return s, r, torch.zeros_like(r, dtype=torch.bool), {"s": s}

    def evaluate_action_sequences(self, st, population, obs, generator, num_particles=1):
        s = obs.expand(population.shape[0], -1)
        total = torch.zeros(population.shape[0])
        for t in range(population.shape[1]):
            s = s + 0.2 * population[:, t]
            total = total - torch.square(s - 1.0).sum(dim=-1)
        return total


TOY_H = 5


def _toy_optimizers():
    bounds = _bounds(TOY_H)
    return {
        "cem": CEMOptimizer(3, 0.2, 40, alpha=0.1, return_mean_elites=True, device="cpu",
                            **bounds),
        "icem": ICEMOptimizer(3, 0.2, 40, population_decay_factor=1.3, colored_noise_exponent=2.0,
                              keep_elite_frac=0.5, alpha=0.1, device="cpu", **bounds),
        "mppi": MPPIOptimizer(4, 50, gamma=1.0, sigma=0.5, beta=0.7, device="cpu", **bounds),
    }


@pytest.mark.parametrize("name", ["cem", "icem", "mppi"])
def test_closed_loop_driver_drives_the_integrator_to_its_optimum(name):
    """Stateful optimizers thread their state through the loop (iCEM its
    kept elites, MPPI its shifted mean, without a second shift)."""
    drv = ClosedLoopDriver(ToyEnv(), _toy_optimizers()[name], horizon=TOY_H, act_dim=1,
                           num_particles=1)
    obs_traj, actions, rewards, dones = drv.run({"params": {}}, np.zeros(1, np.float32), _gen(0),
                                                num_steps=25)
    assert float(obs_traj[-1, 0]) > 0.7, name
    assert bool(torch.isfinite(actions).all())


@pytest.mark.parametrize("model_kind", ["gaussian_mlp", "basic_ensemble"])
@pytest.mark.parametrize("optimizer", ["cem", "mppi"])
def test_driver_equals_the_hand_written_loop(model_kind, optimizer):
    if model_kind == "gaussian_mlp":
        model = GaussianMLP(OBS_DIM + ACT_DIM, OBS_DIM + 1, num_layers=2, ensemble_size=4,
                            hid_size=8, propagation_method="random_model", device="cpu")
    else:
        member = GaussianMLP(OBS_DIM + ACT_DIM, OBS_DIM + 1, num_layers=2, ensemble_size=1,
                             hid_size=8, device="cpu")
        model = BasicEnsemble(4, member, propagation_method="fixed_model")
    wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=False)
    state = {"params": model.set_elite(model.init(_gen(3)), [0, 1, 3]), "normalizer": None}
    env = ModelEnv(wrapper, _no_term, None)

    def make_opt():
        if optimizer == "cem":
            return _cem(24)
        return MPPIOptimizer(2, 24, gamma=1.0, sigma=0.5, beta=0.7, device="cpu", **_bounds())

    driver = ClosedLoopDriver(env, make_opt(), HORIZON, ACT_DIM, num_particles=3)
    obs0 = np.array([0.3, -0.2], np.float32)
    got = driver.run(state, obs0, _gen(5), num_steps=5)
    # chip_smoke.py's loop (the card's check of the driver), on a driver of
    # its own with a fresh optimizer
    want = _chip_smoke().hand_loop(ClosedLoopDriver(env, make_opt(), HORIZON, ACT_DIM, num_particles=3),
                     state, obs0, _gen(5), 5)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) == 0.0


def _jax_toy_env():
    class JaxToyEnv:
        class DM:
            model = None

        dynamics_model = DM()

        def reset(self, st, obs_rows, key):
            return {"s": obs_rows}

        def _step_impl(self, st, action, env_state, key, sample=True):
            s = env_state["s"] + 0.2 * action
            r = -jnp.square(s - 1.0).sum(axis=-1, keepdims=True)
            return s, r, jnp.zeros_like(r, bool), {"s": s}

        def _evaluate_impl(self, st, population, obs, key, num_particles=1):
            def score(seq):
                def stp(s, a):
                    s2 = s + 0.2 * a
                    return s2, -jnp.square(s2 - 1.0).sum()

                _, rs = jax.lax.scan(stp, obs, seq)
                return rs.sum()

            return jax.vmap(score)(population)

    return JaxToyEnv()


def test_integrator_final_state_agrees_with_jax():
    """CEM through both drivers, 64 seeds each, 6 steps (short of the optimum,
    so the final state still varies): equal means within five standard errors
    and interquartile ranges within a factor of 2 (the spread has a long lower
    tail in both packages, so the variance is not compared)."""
    n, steps = 64, 6
    bounds = _bounds(TOY_H)
    ours = ClosedLoopDriver(ToyEnv(), CEMOptimizer(2, 0.2, 20, alpha=0.1, device="cpu", **bounds),
                            horizon=TOY_H, act_dim=1, num_particles=1)
    ref = JaxDriver(_jax_toy_env(), JaxCEM(2, 0.2, 20, alpha=0.1, **bounds), horizon=TOY_H,
                    act_dim=1, num_particles=1)
    obs0 = np.zeros(1, np.float32)
    got = np.array([float(ours.run({"params": {}}, obs0, _gen(s), steps)[0][-1, 0])
                    for s in range(n)])
    want = np.array([float(ref.run({"params": {}}, obs0, jax.random.PRNGKey(s), steps)[0][-1, 0])
                     for s in range(n)])
    se = np.sqrt(got.var(ddof=1) / n + want.var(ddof=1) / n)
    assert abs(got.mean() - want.mean()) < 5 * se, (got.mean(), want.mean(), se)

    def iqr(a):
        return np.subtract(*np.percentile(a, [75, 25]))

    assert 0.5 < iqr(got) / iqr(want) < 2
    assert 0.3 < got.mean() < 1.0
