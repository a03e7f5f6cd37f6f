"""The port's CEM optimizer and MPC agent (mbrl_tpu_torch/planning), mirroring
tests/test_optimizers.py for CEM, plus an end-to-end plan against mbrl_tpu's
agent on converted weights (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mbrl_tpu.envs.termination_fns as jtf
from mbrl_tpu.models import GaussianMLP as JaxGaussianMLP
from mbrl_tpu.models import ModelEnv as JaxModelEnv
from mbrl_tpu.models import TransitionRewardModel as JaxTRM
from mbrl_tpu.planning import CEMOptimizer as JaxCEM
from mbrl_tpu.planning import TrajectoryOptimizerAgent as JaxAgent
from mbrl_tpu.planning.trajectory_opt import (
    create_trajectory_optim_agent_for_model as jax_bind,
)
from mbrl_tpu_torch import convert
from mbrl_tpu_torch.envs import termination_fns
from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel
from mbrl_tpu_torch.planning import (
    CEMOptimizer,
    RandomAgent,
    TrajectoryOptimizer,
    TrajectoryOptimizerAgent,
    create_trajectory_optim_agent_for_model,
)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def neg_rosenbrock(population, *args):
    """Population shape (P, 1, 2) -> maximize at (1, 1)."""
    x = population[:, 0, 0]
    y = population[:, 0, 1]
    return -(torch.square(1 - x) + 100.0 * torch.square(y - torch.square(x)))


def quadratic_obj(population, center, *_):
    return -torch.square(population - center).sum(dim=(1, 2))


def test_cem_rosenbrock():
    opt = CEMOptimizer(100, 0.1, 500, [[-2.0, -2.0]], [[2.0, 2.0]], alpha=0.1, device="cpu")
    best, _ = opt.optimize(neg_rosenbrock, torch.zeros((1, 2)), _gen())
    value = float(neg_rosenbrock(best[None])[0])
    best = best.numpy()[0]
    assert value > -0.1, (best, value)
    np.testing.assert_allclose(best[1], best[0] ** 2, atol=0.05)


def test_cem_clipped_normal_and_mean_elites():
    opt = CEMOptimizer(5, 0.2, 200, [[-1.0]] * 3, [[1.0]] * 3, alpha=0.0,
                       return_mean_elites=True, clipped_normal=True, device="cpu")
    best, _ = opt.optimize(quadratic_obj, torch.zeros((3, 1)), _gen(), obj_args=(0.3 * torch.ones((3, 1)),))
    np.testing.assert_allclose(best.numpy(), 0.3, atol=0.1)


def test_cem_respects_bounds():
    opt = CEMOptimizer(5, 0.1, 100, [[-0.5]] * 4, [[0.25]] * 4, alpha=0.1, device="cpu")
    seen = []

    def obj(pop, *a):
        seen.append(pop)
        return -torch.square(pop - 10.0).sum(dim=(1, 2))  # optimum far above ub

    best, _ = opt.optimize(obj, torch.zeros((4, 1)), _gen())
    assert bool((best <= 0.25 + 1e-5).all() and (best >= -0.5 - 1e-5).all())
    pops = torch.stack(seen)
    assert bool((pops <= 0.25 + 1e-5).all() and (pops >= -0.5 - 1e-5).all())


def test_cem_nan_guard():
    opt = CEMOptimizer(3, 0.2, 50, [[-1.0]], [[1.0]], alpha=0.1, device="cpu")

    def obj(pop, *a):
        vals = -torch.square(pop).sum(dim=(1, 2))
        return torch.where(pop[:, 0, 0] > 0, torch.full_like(vals, float("nan")), vals)

    best, _ = opt.optimize(obj, torch.zeros((1, 1)), _gen())
    assert bool(torch.isfinite(best).all())


def test_cem_callback_per_iteration():
    calls = []
    opt = CEMOptimizer(4, 0.2, 50, [[-1.0]] * 3, [[1.0]] * 3, alpha=0.1, device="cpu")
    opt.optimize(quadratic_obj, torch.zeros((3, 1)), _gen(), obj_args=(0.3,),
                 callback=lambda p, v, i: calls.append((tuple(p.shape), tuple(v.shape), i)))
    assert [c[2] for c in calls] == [0, 1, 2, 3]
    assert all(c[0] == (50, 3, 1) and c[1] == (50,) for c in calls)


def test_trajectory_optimizer_warm_start():
    cem = CEMOptimizer(5, 0.1, 100, [[-1.0]] * 6, [[1.0]] * 6, alpha=0.1, device="cpu")
    topt = TrajectoryOptimizer(cem, np.array([-1.0]), np.array([1.0]), planning_horizon=6, replan_freq=2)
    sol = topt.optimize(quadratic_obj, _gen(), obj_args=(0.5 * torch.ones((6, 1)),))
    assert sol.shape == (6, 1)
    # warm start shifted by replan_freq, tail filled with the initial solution (0)
    prev = topt.previous_solution.numpy()
    np.testing.assert_allclose(prev[:4], sol[2:], atol=1e-6)
    np.testing.assert_allclose(prev[4:], 0.0, atol=1e-6)
    topt.reset()
    np.testing.assert_allclose(topt.previous_solution.numpy(), 0.0)


def test_trajectory_optimizer_takes_the_optimizers_device_and_never_picks_one():
    """An optimizer without a ``device`` raises: the warm start does not land
    on the CPU quietly."""

    class NoDevice:
        def init_state(self):
            return None

    with pytest.raises(ValueError, match="device"):
        TrajectoryOptimizer(NoDevice(), np.array([-1.0]), np.array([1.0]), planning_horizon=3)
    cem = CEMOptimizer(2, 0.1, 10, [[-1.0]] * 3, [[1.0]] * 3, alpha=0.1, device="cpu")
    topt = TrajectoryOptimizer(cem, np.array([-1.0]), np.array([1.0]), planning_horizon=3)
    assert topt.initial_solution.device == cem.device == torch.device("cpu")


def _agent(horizon=4, replan_freq=2, lb=-1.0, ub=1.0):
    cem = CEMOptimizer(4, 0.1, 60, [[lb]] * horizon, [[ub]] * horizon, alpha=0.1, device="cpu")
    return TrajectoryOptimizerAgent(cem, action_lb=[lb], action_ub=[ub],
                                    planning_horizon=horizon, replan_freq=replan_freq)


def test_agent_caching_and_plan():
    agent = _agent()
    agent.set_trajectory_eval_fn(
        lambda seqs, state, obs, gen: -torch.square(seqs - 0.25).sum(dim=(1, 2)))
    obs = np.zeros(2, np.float32)
    a1 = agent.act(obs)
    agent.act(obs)  # cached, no new plan
    assert agent._act_counter == 1
    agent.act(obs)  # replan
    assert agent._act_counter == 2
    assert a1.shape == (1,)
    np.testing.assert_allclose(a1, 0.25, atol=0.15)
    assert agent.plan(obs).shape == (4, 1)
    with pytest.raises(RuntimeError):
        _agent().act(obs)


def test_agent_reset_new_horizon_keeps_action_bounds():
    """mbrl-lib semantics: reset(planning_horizon=...) rebuilds the plan from
    the real action bounds, tiled over the new horizon. (mbrl_tpu passes
    initial_solution[0] as both bounds, trajectory_opt.py:477-487, and keeps
    the optimizer's old-horizon bounds, so its next plan cannot run.)"""
    agent = _agent(horizon=3, replan_freq=1, lb=-1.0, ub=0.5)
    agent.reset(planning_horizon=5)
    topt = agent.optimizer
    assert topt.horizon == 5 and tuple(topt.initial_solution.shape) == (5, 1)
    np.testing.assert_allclose(topt.initial_solution.numpy(), -0.25)
    np.testing.assert_allclose(topt.optimizer.lower_bound.numpy(), np.full((5, 1), -1.0))
    np.testing.assert_allclose(topt.optimizer.upper_bound.numpy(), np.full((5, 1), 0.5))
    # the new plan leaves the midpoint toward the optimum and stays in bounds
    agent.set_trajectory_eval_fn(
        lambda seqs, state, obs, gen: -torch.square(seqs - 0.4).sum(dim=(1, 2)))
    a = agent.act(np.zeros(1, np.float32))
    assert 0.0 < float(a[0]) <= 0.5

    jagent = JaxAgent(JaxCEM(4, 0.1, 60, [[-1.0]] * 3, [[0.5]] * 3, alpha=0.1),
                      action_lb=[-1.0], action_ub=[0.5], planning_horizon=3)
    jagent.reset(planning_horizon=5)
    jagent.set_trajectory_eval_fn(
        lambda seqs, state, obs, key: -jnp.square(seqs - 0.4).sum(axis=(1, 2)))
    # the reference's fault: its optimizer still holds (3, 1) bounds
    with pytest.raises(TypeError):
        jagent.act(np.zeros(1, np.float32))


def test_random_agent():
    class Space:
        def sample(self):
            return np.ones(2)

    class Env:
        action_space = Space()

    np.testing.assert_array_equal(RandomAgent(Env()).act(None), np.ones(2))
    assert RandomAgent(Env()).plan(None).shape == (1, 2)


def test_end_to_end_first_action_matches_jax_agent():
    """A port agent and a JAX agent plan on the same converted weights of a
    stochastic 3-member ensemble (sort shuffle, normalizer) whose reward has a
    unique best action, a = 0.4 in every dim: their first actions agree
    within 0.1 of each other and of the optimum."""
    obs_dim, act_dim, horizon = 4, 2, 5
    common = dict(in_size=obs_dim + act_dim, out_size=obs_dim, num_layers=2, ensemble_size=3,
                  hid_size=16, activation="silu", propagation_method="random_model")
    wkw = dict(target_is_delta=True, normalize=True, learned_rewards=False)
    jw = JaxTRM(JaxGaussianMLP(**common), **wkw)
    tw = TransitionRewardModel(GaussianMLP(device="cpu", **common), **wkw)
    jstate = jw.set_elite(jw.init(jax.random.PRNGKey(0)), [0, 2])
    tstate = convert.convert_state(jax.tree_util.tree_map(np.asarray, jstate), "cpu")

    def jreward(act, next_obs):
        return (-jnp.square(act - 0.4).sum(axis=1) + 1e-3 * next_obs[:, 0])[:, None]

    def treward(act, next_obs):
        return (-torch.square(act - 0.4).sum(dim=1) + 1e-3 * next_obs[:, 0])[:, None]

    lb, ub = [-1.0] * act_dim, [1.0] * act_dim
    cem_kw = dict(num_iterations=5, elite_ratio=0.1, population_size=200,
                  lower_bound=[lb] * horizon, upper_bound=[ub] * horizon, alpha=0.1,
                  return_mean_elites=True)
    jagent = jax_bind(JaxModelEnv(jw, jtf.no_termination, reward_fn=jreward),
                      JaxAgent(JaxCEM(**cem_kw), lb, ub, planning_horizon=horizon), num_particles=4)
    jagent.set_eval_state(jstate)
    tagent = create_trajectory_optim_agent_for_model(
        ModelEnv(tw, termination_fns.no_termination, reward_fn=treward),
        TrajectoryOptimizerAgent(CEMOptimizer(device="cpu", **cem_kw), lb, ub, planning_horizon=horizon),
        num_particles=4,
    )
    tagent.set_eval_state(tstate)
    obs = np.full(obs_dim, 0.1, np.float32)
    ja, ta = np.asarray(jagent.act(obs)), tagent.act(obs)
    assert ta.shape == (act_dim,) and np.isfinite(ta).all()
    np.testing.assert_allclose(ta, ja, atol=0.1)
    np.testing.assert_allclose(ta, 0.4, atol=0.1)
