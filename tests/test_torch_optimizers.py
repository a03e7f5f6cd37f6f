"""MPPI, iCEM and ``act_batch`` of the port (CPU), mirroring mbrl_tpu's
tests/test_optimizers.py; the population schedule is held equal to the JAX
class's for a grid of arguments."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbrl_tpu.planning import ICEMOptimizer as JaxICEM
from mbrl_tpu_torch.planning import (
    CEMOptimizer, ICEMOptimizer, MPPIOptimizer, TrajectoryOptimizer, TrajectoryOptimizerAgent,
)


def neg_rosenbrock(population, *args):
    """Population shape (P, 1, 2) -> maximize at (1, 1)."""
    x, y = population[:, 0, 0], population[:, 0, 1]
    return -(torch.square(1 - x) + 100.0 * torch.square(y - torch.square(x)))


def quadratic_obj(population, center, _gen=None):
    return -torch.square(population - center).sum(dim=(1, 2))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_mppi_quadratic_and_state_shift():
    h, a = 5, 2
    opt = MPPIOptimizer(num_iterations=10, population_size=300, gamma=10.0, sigma=0.8, beta=0.7,
                        lower_bound=[[-1.0] * a] * h, upper_bound=[[1.0] * a] * h, device="cpu")
    center = 0.4 * torch.ones((h, a))
    state = opt.init_state()
    assert state.shape == (h, a) and not state.any()
    sols = []
    for i in range(10):
        sol, state = opt.optimize(quadratic_obj, None, _gen(i), state, obj_args=(center,))
        assert state is sol  # the persistent mean is the solution
        sols.append(sol.numpy())
    tail = np.stack(sols[3:])
    assert abs(tail.mean() - 0.4) < 0.1, tail.mean()
    assert np.all(tail <= 1.0) and np.all(tail >= -1.0)
    # () stands for "no state yet"
    sol, _ = opt.optimize(quadratic_obj, None, _gen(0), (), obj_args=(center,))
    assert sol.shape == (h, a)


def test_mppi_shifts_its_mean_inside_optimize_and_ignores_x0():
    """With zero refinements nothing but the shift happens: the mean moves one
    step left, the last row repeated; the TrajectoryOptimizer's own warm start
    (x0) plays no part, so the mean is not shifted twice."""
    h = 4
    opt = MPPIOptimizer(0, 10, 1.0, 1.0, 0.5, [[-1.0]] * h, [[1.0]] * h, device="cpu")
    mean = torch.tensor([[0.1], [0.2], [0.3], [0.4]])
    out, state = opt.optimize(quadratic_obj, torch.full((h, 1), 9.0), _gen(), mean)
    assert out.flatten().tolist() == pytest.approx([0.2, 0.3, 0.4, 0.4])
    traj = TrajectoryOptimizer(opt, np.array([-1.0]), np.array([1.0]), planning_horizon=h)
    traj.opt_state = mean
    traj.optimize(quadratic_obj, _gen(), obj_args=(torch.zeros((h, 1)),))
    assert traj.opt_state.flatten().tolist() == pytest.approx([0.2, 0.3, 0.4, 0.4])
    traj.optimize(quadratic_obj, _gen(), obj_args=(torch.zeros((h, 1)),))
    assert traj.opt_state.flatten().tolist() == pytest.approx([0.3, 0.4, 0.4, 0.4])
    traj.reset()
    assert not traj.opt_state.any()


def test_mppi_population_uses_the_unscaled_noise():
    """sigma does not reach the population (mbrl-lib's and the JAX package's
    behaviour): two sigmas give the same candidates from the same generator."""
    seen = {}
    for sigma in (0.1, 5.0):
        opt = MPPIOptimizer(1, 50, 1.0, sigma, 0.6, [[-3.0]] * 3, [[3.0]] * 3, device="cpu")
        opt.optimize(quadratic_obj, None, _gen(3), None, obj_args=(torch.zeros((3, 1)),),
                     callback=lambda pop, vals, it: seen.__setitem__(sigma, pop.clone()))
    assert torch.equal(seen[0.1], seen[5.0])
    assert float(seen[0.1].std()) > 0.3  # unit-scale noise, not sigma 0.1


def test_icem_rosenbrock():
    opt = ICEMOptimizer(num_iterations=30, elite_ratio=0.1, population_size=400,
                        population_decay_factor=1.25, colored_noise_exponent=0.25,
                        lower_bound=[[-2.0, -2.0]], upper_bound=[[2.0, 2.0]], keep_elite_frac=0.1,
                        alpha=0.1, device="cpu")
    best, opt_state = opt.optimize(neg_rosenbrock, torch.zeros((1, 2)), _gen(0))
    value = float(neg_rosenbrock(best[None])[0])
    best = best.numpy()[0]
    assert value > -0.15, (best, value)  # on the valley floor near the optimum
    np.testing.assert_allclose(best[1], best[0] ** 2, atol=0.05)
    assert opt_state["valid"] is True and opt_state["elite"].shape[0] == opt.elite_num
    best2, _ = opt.optimize(neg_rosenbrock, torch.zeros((1, 2)), _gen(1), opt_state)
    assert torch.isfinite(best2).all()


@pytest.mark.parametrize("iters,ratio,pop,decay,keep,module", list(itertools.product(
    (1, 3, 5), (0.1, 0.16), (60, 200, 350), (1.0, 1.3), (0.3,), (None, 5, 7))))
def test_icem_population_schedule_equals_the_jax_class(iters, ratio, pop, decay, keep, module):
    lb, ub = [[-1.0]] * 4, [[1.0]] * 4
    want = JaxICEM(iters, ratio, pop, decay, 2.0, lb, ub, keep, 0.1, population_size_module=module)
    got = ICEMOptimizer(iters, ratio, pop, decay, 2.0, lb, ub, keep, 0.1,
                        population_size_module=module, device="cpu")
    assert got.decay_population_sizes == want.decay_population_sizes
    assert got.elite_num == want.elite_num and got.keep_elite_size == want.keep_elite_size
    assert (got.horizon, got.action_dim) == (want.horizon, want.action_dim) == (4, 1)
    if module:
        assert all(p % module == 0 for p in got.decay_population_sizes)
        assert got.keep_elite_size % module == 0


def _sizes(opt, obj, x0, gen, state=None):
    pops = []
    out = opt.optimize(obj, x0, gen, state, callback=lambda pop, vals, it: pops.append(pop.clone()))
    return pops, out


def test_icem_appends_the_mean_at_the_last_iteration_even_when_it_is_the_first():
    """num_iterations == 1: mbrl-lib appends the running mean at the last
    iteration, which is then also the first; the JAX package's ``elif`` drops
    it there. The port follows mbrl-lib. With more iterations both agree: the
    mean alone takes the kept elites' place at the last one."""
    lb, ub = [[-1.0]] * 3, [[1.0]] * 3
    kw = dict(elite_ratio=0.1, population_size=40, population_decay_factor=1.3,
              colored_noise_exponent=2.0, lower_bound=lb, upper_bound=ub, keep_elite_frac=0.5,
              alpha=0.1)
    x0 = 0.25 * torch.ones((3, 1))
    one = ICEMOptimizer(num_iterations=1, device="cpu", **kw)
    pops, _ = _sizes(one, quadratic_obj_zero, x0, _gen())
    assert len(pops) == 1
    assert pops[0].shape[0] == one.decay_population_sizes[0] + one.keep_elite_size + 1
    assert torch.equal(pops[0][-1], x0)  # the last candidate is the mean itself

    jax_one = JaxICEM(num_iterations=1, **kw)
    jax_pops = []
    jax_one.optimize(lambda pop, *a: -jnp.square(pop).sum(axis=(1, 2)), jnp.asarray(x0.numpy()),
                     jax.random.PRNGKey(0),
                     callback=lambda pop, vals, it: jax_pops.append(np.asarray(pop)))
    jax.effects_barrier()
    assert jax_pops[0].shape[0] == jax_one.decay_population_sizes[0] + jax_one.keep_elite_size

    three = ICEMOptimizer(num_iterations=3, device="cpu", **kw)
    pops, (_, state) = _sizes(three, quadratic_obj_zero, x0, _gen())
    sizes = three.decay_population_sizes
    assert [p.shape[0] for p in pops] == [sizes[0] + three.keep_elite_size,
                                          sizes[1] + three.keep_elite_size, sizes[2] + 1]
    # no elites yet on the first call: the mean stands in for the kept rows
    assert torch.equal(pops[0][-1], x0) and torch.equal(pops[0][sizes[0]], x0)
    # a second call reuses the elites, shifted by one step
    pops2, _ = _sizes(three, quadratic_obj_zero, x0, _gen(1), state)
    kept = pops2[0][sizes[0]:]
    assert not torch.equal(kept[0], x0)
    shifted = {tuple(np.round(e[1:].flatten().tolist(), 6)) for e in state["elite"]}
    assert all(tuple(np.round(k[:-1].flatten().tolist(), 6)) in shifted for k in kept)


def quadratic_obj_zero(population, *args):
    return -torch.square(population).sum(dim=(1, 2))


def test_optimizer_callbacks_invoked_per_iteration():
    calls = []

    def cb(population, values, it):
        calls.append((tuple(population.shape), tuple(values.shape), int(it)))

    lb, ub = [[-1.0]] * 3, [[1.0]] * 3
    center = 0.3 * torch.ones((3, 1))
    mppi = MPPIOptimizer(3, 40, gamma=1.0, sigma=0.5, beta=0.7, lower_bound=lb, upper_bound=ub,
                         device="cpu")
    mppi.optimize(quadratic_obj, torch.zeros((3, 1)), _gen(), obj_args=(center,), callback=cb)
    assert [c[2] for c in calls] == [0, 1, 2]
    assert all(c[0] == (40, 3, 1) and c[1] == (40,) for c in calls)
    calls.clear()
    icem = ICEMOptimizer(num_iterations=3, elite_ratio=0.1, population_size=60,
                         population_decay_factor=1.3, colored_noise_exponent=2.0, lower_bound=lb,
                         upper_bound=ub, keep_elite_frac=0.3, alpha=0.1, device="cpu")
    icem.optimize(quadratic_obj, torch.zeros((3, 1)), _gen(), obj_args=(center,), callback=cb)
    assert [c[2] for c in calls] == [0, 1, 2]
    assert calls[0][0][0] >= calls[1][0][0] >= calls[2][0][0]  # the population decays


def test_nan_values_are_guarded():
    def nan_obj(population, *args):
        vals = -torch.square(population).sum(dim=(1, 2))
        return torch.where(population[:, 0, 0] > 0.5, torch.full_like(vals, float("nan")), vals)

    lb, ub = [[-1.0]] * 2, [[1.0]] * 2
    for opt in (MPPIOptimizer(3, 60, 1.0, 1.0, 0.7, lb, ub, device="cpu"),
                ICEMOptimizer(3, 0.1, 60, 1.3, 2.0, lb, ub, 0.3, 0.1, device="cpu")):
        sol, _ = opt.optimize(nan_obj, torch.zeros((2, 1)), _gen(), None)
        assert torch.isfinite(sol).all()


def _obs_eval_fn(action_sequences, eval_state, obs, generator):
    # the best action of an environment is its observation's first entry
    return -torch.square(action_sequences - obs[0]).sum(dim=(1, 2))


def _cem_agent(seed=0, replan_freq=2):
    cem = CEMOptimizer(4, 0.2, 60, [[-1.0]] * 4, [[1.0]] * 4, alpha=0.1, device="cpu")
    agent = TrajectoryOptimizerAgent(cem, action_lb=[-1.0], action_ub=[1.0], planning_horizon=4,
                                     replan_freq=replan_freq, seed=seed)
    agent.set_trajectory_eval_fn(_obs_eval_fn)
    return agent


def test_act_batch_plans_each_environment_with_its_own_state():
    agent = _cem_agent()
    obs = np.array([[0.3, 0.0], [-0.5, 0.0], [0.0, 0.0]], np.float32)
    plans = []
    orig = agent._plan
    agent._plan = lambda *a, **k: plans.append(1) or orig(*a, **k)
    a1 = agent.act_batch(obs)
    assert a1.shape == (3, 1) and len(plans) == 3
    agent.act_batch(obs)  # cached row (replan_freq=2): no new plan
    assert len(plans) == 3
    a3 = agent.act_batch(obs)
    assert len(plans) == 6
    np.testing.assert_allclose(a3[:, 0], obs[:, 0], atol=0.25)  # each toward its own optimum
    st = agent._batch_state
    assert len(st["planners"]) == 3 and len(st["generators"]) == 3 and len(st["cache"]) == 1
    warm = [p.previous_solution.clone() for p in st["planners"]]
    assert not torch.equal(warm[0], warm[1])
    # a boundary for environment 1 only: its warm start is cleared, the others' kept;
    # the cache is dropped and everyone plans again
    agent._plan = orig
    seen = {}
    def spy(obs_i, planner=None, generator=None, **k):
        seen[id(planner)] = planner.previous_solution.clone()
        return orig(obs_i, planner=planner, generator=generator, **k)
    agent._plan = spy
    agent.act_batch(obs, reset_mask=np.array([False, True, False]))
    planners = st["planners"]
    assert torch.equal(seen[id(planners[1])], planners[1].initial_solution)
    assert torch.equal(seen[id(planners[0])], warm[0]) and torch.equal(seen[id(planners[2])], warm[2])
    assert agent.act(obs, batched=True).shape == (3, 1)  # the pool's way in
    agent.reset()
    assert agent._batch_state is None


def test_act_batch_equals_separate_agents_with_the_same_generators():
    obs = np.array([[0.3, 0.0], [-0.5, 0.0], [0.1, 0.0], [0.7, 0.0]], np.float32)
    batch_agent = _cem_agent(seed=5, replan_freq=1)
    singles = []
    for w in range(4):
        single = _cem_agent(seed=99, replan_freq=1)
        single._generator = batch_agent.batch_generator(w)
        singles.append(single)
    for step in range(3):
        got = batch_agent.act_batch(obs + 0.01 * step)
        want = np.stack([s.act(obs[w] + 0.01 * step) for w, s in enumerate(singles)])
        np.testing.assert_array_equal(got, want)


def test_act_batch_threads_icem_and_mppi_state_per_environment():
    obs = np.array([[0.3, 0.0], [-0.5, 0.0], [0.0, 0.0]], np.float32)
    lb, ub = [[-1.0]] * 4, [[1.0]] * 4
    icem = ICEMOptimizer(3, 0.2, 40, population_decay_factor=1.3, colored_noise_exponent=2.0,
                         keep_elite_frac=0.5, alpha=0.1, lower_bound=lb, upper_bound=ub, device="cpu")
    agent = TrajectoryOptimizerAgent(icem, [-1.0], [1.0], planning_horizon=4, replan_freq=1)
    agent.set_trajectory_eval_fn(_obs_eval_fn)
    for _ in range(4):
        actions = agent.act_batch(obs)
    np.testing.assert_allclose(actions[:, 0], obs[:, 0], atol=0.3)
    states = [p.opt_state for p in agent._batch_state["planners"]]
    assert all(s["valid"] for s in states)
    assert not torch.equal(states[0]["elite"], states[1]["elite"])
    mppi = MPPIOptimizer(5, 100, 10.0, 1.0, 0.7, lb, ub, device="cpu")
    agent = TrajectoryOptimizerAgent(mppi, [-1.0], [1.0], planning_horizon=4, replan_freq=1)
    agent.set_trajectory_eval_fn(_obs_eval_fn)
    for _ in range(3):
        actions = agent.act_batch(obs)
    means = [p.opt_state for p in agent._batch_state["planners"]]
    assert means[0].mean() > means[2].mean() > means[1].mean()
    with pytest.raises(RuntimeError, match="set_trajectory_eval_fn"):
        TrajectoryOptimizerAgent(mppi, [-1.0], [1.0], planning_horizon=4).act_batch(obs)
