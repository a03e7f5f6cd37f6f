"""The port's GaussianMLP, TransitionRewardModel, math, normalizer and env
functions against mbrl_tpu on converted weights (CPU, small sizes).

Inputs, permutations and propagation indices come from numpy and are fed to
both sides. Tolerance 1e-5 (f32, float-sum order) unless stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mbrl_tpu.envs.reward_fns as jrf
import mbrl_tpu.envs.termination_fns as jtf
from mbrl_tpu.envs.pets_halfcheetah import HalfCheetahEnv as JaxHalfCheetah
from mbrl_tpu.models import GaussianMLP as JaxGaussianMLP
from mbrl_tpu.models import ModelEnv as JaxModelEnv
from mbrl_tpu.models import TransitionRewardModel as JaxTRM
from mbrl_tpu.ops import normalizer as jnrm
from mbrl_tpu_torch import convert
from mbrl_tpu_torch.envs import reward_fns, termination_fns
from mbrl_tpu_torch.envs.pets_halfcheetah import HalfCheetahEnv
from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel
from mbrl_tpu_torch.ops import math as tmath
from mbrl_tpu_torch.ops import normalizer as nrm

IN, OUT, E, HID = 6, 4, 3, 16


def _pair(**kw):
    common = dict(in_size=IN, out_size=OUT, num_layers=2, ensemble_size=E, hid_size=HID,
                  activation="silu")
    common.update(kw)
    return JaxGaussianMLP(**common), GaussianMLP(device="cpu", **common)


def _params(jmodel, elite=(0, 2)):
    params = jmodel.init(jax.random.PRNGKey(0))
    # non-zero biases so the bias path is exercised
    params["layers"][0]["b"] = 0.1 * jnp.ones_like(params["layers"][0]["b"])
    params = jmodel.set_elite(params, list(elite))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return params, convert.convert_params(np_params, "cpu")


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("use_only_elite", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(use_only_elite, compute_dtype):
    jm, tm = _pair(compute_dtype=compute_dtype)
    jp, tp = _params(jm)
    x = np.random.default_rng(0).standard_normal((10, IN)).astype(np.float32)
    jmean, jlv = jm.forward(jp, jnp.asarray(x), use_only_elite=use_only_elite)
    tmean, tlv = tm.forward(tp, torch.from_numpy(x), use_only_elite=use_only_elite)
    assert tmean.shape == ((2 if use_only_elite else E), 10, OUT)
    tol = 1e-5 if compute_dtype == "float32" else 2e-2
    _close(jmean, tmean, tol)
    _close(jlv, tlv, tol)


def test_forward_deterministic_head():
    jm, tm = _pair(deterministic=True)
    jp, tp = _params(jm)
    assert "min_logvar" not in tp
    x = np.random.default_rng(1).standard_normal((E, 5, IN)).astype(np.float32)
    jmean, jlv = jm.forward(jp, jnp.asarray(x))
    tmean, tlv = tm.forward(tp, torch.from_numpy(x))
    assert jlv is None and tlv is None
    _close(jmean, tmean)


def test_forward_sharded_matches_jax():
    jm, tm = _pair(propagation_method="random_model")
    jp, tp = _params(jm)
    batch = 12
    x = np.random.default_rng(2).standard_normal((batch, IN)).astype(np.float32)
    perm = np.random.default_rng(3).permutation(batch)
    jmean, jlv = jm._forward_sharded(jp, jnp.asarray(x), jnp.asarray(perm, jnp.int32))
    tmean, tlv = tm._forward_sharded(tp, torch.from_numpy(x), torch.from_numpy(perm))
    _close(jmean, tmean)
    _close(jlv, tlv)


@pytest.mark.parametrize("batch", [12, 13])  # sharded and per-row fallback
@pytest.mark.parametrize("method", ["random_model", "fixed_model", "expectation"])
def test_forward_propagated_matches_jax(method, batch):
    jm, tm = _pair(propagation_method=method)
    jp, tp = _params(jm)
    x = np.random.default_rng(4).standard_normal((batch, IN)).astype(np.float32)
    perm = np.random.default_rng(5).permutation(batch)
    inv = np.argsort(perm)
    if method == "random_model" and batch % 2:
        # the per-row fallback draws its members from the key/generator; check
        # each row against the all-elite forward instead
        tmean, _ = tm.forward_propagated(tp, torch.from_numpy(x), generator=torch.Generator())
        all_mean, _ = tm.forward(tp, torch.from_numpy(x), use_only_elite=True)
        match = (all_mean - tmean[None]).abs().amax(-1) < 1e-6
        assert bool(match.any(0).all())
        return
    kw_j, kw_t = {}, {}
    if method == "random_model":
        kw_j["precomputed"] = (jnp.asarray(perm, jnp.int32), jnp.asarray(inv, jnp.int32))
        kw_t["precomputed"] = (torch.from_numpy(perm), torch.from_numpy(inv))
    elif method == "fixed_model":
        kw_j["propagation_indices"] = jnp.asarray(perm, jnp.int32)
        kw_t["propagation_indices"] = torch.from_numpy(perm)
    jmean, jlv = jm.forward_propagated(jp, jnp.asarray(x), **kw_j)
    tmean, tlv = tm.forward_propagated(tp, torch.from_numpy(x), **kw_t)
    assert tmean.shape == (batch, OUT)
    _close(jmean, tmean)
    _close(jlv, tlv)


def test_init_layout_and_elites():
    tm = GaussianMLP(IN, OUT, num_layers=3, ensemble_size=E, hid_size=HID, device="cpu")
    p = tm.init(torch.Generator().manual_seed(0))
    assert [tuple(l["w"].shape) for l in p["layers"]] == [(E, IN, HID), (E, HID, HID), (E, HID, HID)]
    assert tuple(p["head"]["w"].shape) == (E, HID, 2 * OUT)
    assert float(p["min_logvar"].max()) == -10.0 and float(p["max_logvar"].min()) == 0.5
    # truncated normal init: within 2 std of 0, std 1/(2*sqrt(fan_in))
    std = 1 / (2 * np.sqrt(IN))
    assert float(p["layers"][0]["w"].abs().max()) <= 2 * std
    p = tm.set_elite(p, [2, 0])
    view = tm._elite_view(p)
    torch.testing.assert_close(view["head"]["w"][0], p["head"]["w"][2])
    with pytest.raises(ValueError):
        GaussianMLP(IN, OUT, activation="nope", device="cpu")
    with pytest.raises(ValueError):
        GaussianMLP(IN, OUT, rollout_shuffle="nope", device="cpu")


def test_truncated_normal_distribution():
    g = torch.Generator().manual_seed(0)
    x = tmath.truncated_normal(g, (200_000,), mean=1.0, std=0.5)
    assert float(x.min()) > 0.0 and float(x.max()) < 2.0
    # moments of N(0,1) truncated at ±2: mean 0, variance 0.7737
    z = (x.double() - 1.0) / 0.5
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.var()) - 0.7737) < 0.01
    jx = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(0), -2.0, 2.0, (200_000,)))
    assert abs(float(z.var()) - jx.var()) < 0.01


def test_normalizer_matches_jax():
    rng = np.random.default_rng(6)
    mean = rng.standard_normal((1, IN)).astype(np.float32)
    std = (rng.random((1, IN)) + 0.5).astype(np.float32)
    x = rng.standard_normal((9, IN)).astype(np.float32)
    js = jnrm.init_normalizer(IN).replace(mean=jnp.asarray(mean), std=jnp.asarray(std))
    ts = nrm.init_normalizer(IN, "cpu").replace(mean=torch.from_numpy(mean), std=torch.from_numpy(std))
    _close(jnrm.normalize(js, jnp.asarray(x)), nrm.normalize(ts, torch.from_numpy(x)))
    _close(jnrm.denormalize(js, jnp.asarray(x)), nrm.denormalize(ts, torch.from_numpy(x)))


@pytest.mark.parametrize(
    "name", ["hopper", "cartpole", "inverted_pendulum", "no_termination", "walker2d", "ant", "humanoid"]
)
def test_termination_fns_match_jax(name):
    rng = np.random.default_rng(7)
    obs = rng.uniform(-1.5, 2.5, (64, 23)).astype(np.float32)
    act = rng.standard_normal((64, 6)).astype(np.float32)
    ref = getattr(jtf, name)(jnp.asarray(act), jnp.asarray(obs))
    got = getattr(termination_fns, name)(torch.from_numpy(act), torch.from_numpy(obs))
    assert got.dtype == torch.bool and got.shape == (64, 1)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("name", ["cartpole", "cartpole_pets", "inverted_pendulum", "halfcheetah", "pusher"])
def test_reward_fns_match_jax(name):
    rng = np.random.default_rng(8)
    obs = rng.uniform(-1.0, 1.0, (64, 23)).astype(np.float32)
    act = rng.standard_normal((64, 6)).astype(np.float32)
    ref = getattr(jrf, name)(jnp.asarray(act), jnp.asarray(obs))
    got = getattr(reward_fns, name)(torch.from_numpy(act), torch.from_numpy(obs))
    assert got.shape == (64, 1)
    _close(ref, got)


def test_halfcheetah_preprocess_and_reward_match_jax():
    rng = np.random.default_rng(9)
    obs = rng.standard_normal((5, 18)).astype(np.float32)
    act = rng.standard_normal((5, 6)).astype(np.float32)
    _close(JaxHalfCheetah.preprocess_fn(jnp.asarray(obs)), HalfCheetahEnv.preprocess_fn(torch.from_numpy(obs)))
    np.testing.assert_allclose(JaxHalfCheetah.get_reward(obs, act), HalfCheetahEnv.get_reward(obs, act))
    np.testing.assert_allclose(JaxHalfCheetah.get_reward(obs[0], act[0]), HalfCheetahEnv.get_reward(obs[0], act[0]))


@pytest.mark.parametrize("learned_rewards", [True, False])
def test_transition_model_sample_matches_jax(learned_rewards):
    """deterministic=True sample: obs_process_fn, no_delta_list, the
    normalizer and the learned-reward column, on converted weights."""
    obs_dim, act_dim = 5, 2
    out = obs_dim + (1 if learned_rewards else 0)
    proc_in = obs_dim + act_dim  # preprocess: obs[1], sin, cos, obs[3:] keeps the width
    common = dict(in_size=proc_in, out_size=out, num_layers=2, ensemble_size=E, hid_size=HID,
                  activation="silu", propagation_method="fixed_model")
    jm, tm = JaxGaussianMLP(**common), GaussianMLP(device="cpu", **common)

    def jax_proc(o):
        return JaxHalfCheetah.preprocess_fn(o)

    kw = dict(target_is_delta=True, normalize=True, learned_rewards=learned_rewards, no_delta_list=[0, 3])
    jw = JaxTRM(jm, obs_process_fn=jax_proc, **kw)
    tw = TransitionRewardModel(tm, obs_process_fn=HalfCheetahEnv.preprocess_fn, **kw)
    jstate = jw.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(10)
    jstate["normalizer"] = jstate["normalizer"].replace(
        mean=jnp.asarray(rng.standard_normal((1, proc_in)), jnp.float32),
        std=jnp.asarray(rng.random((1, proc_in)) + 0.5, jnp.float32),
    )
    jstate = jw.set_elite(jstate, [1, 2])
    tstate = convert.convert_state(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    batch = 8
    obs = rng.standard_normal((batch, obs_dim)).astype(np.float32)
    act = rng.standard_normal((batch, act_dim)).astype(np.float32)
    perm = rng.permutation(batch)
    jms = {"obs": jnp.asarray(obs), "propagation_indices": jnp.asarray(perm, jnp.int32)}
    tms = {"obs": torch.from_numpy(obs), "propagation_indices": torch.from_numpy(perm)}
    jn, jr, _ = jw.sample(jstate, jnp.asarray(act), jms, jax.random.PRNGKey(0), deterministic=True)
    tn, tr, tms2 = tw.sample(tstate, torch.from_numpy(act), tms, torch.Generator(), deterministic=True)
    _close(jn, tn)
    if learned_rewards:
        _close(jr, tr)
    else:
        assert jr is None and tr is None
    torch.testing.assert_close(tms2["obs"], tn)


def test_model_env_step_and_reset_follow_propagation():
    """fixed_model keeps each particle on one member; reset/step run end to end."""
    tm = GaussianMLP(4, 3, num_layers=2, ensemble_size=3, hid_size=8,
                     propagation_method="fixed_model", device="cpu")
    tw = TransitionRewardModel(tm, target_is_delta=True, learned_rewards=True)
    state = tw.init(torch.Generator().manual_seed(0))
    env = ModelEnv(tw, termination_fns.no_termination)
    g = torch.Generator().manual_seed(1)
    ms = env.reset(state, np.zeros((9, 2), np.float32), g)
    nxt, rew, term, ms2 = env.step(state, np.zeros((9, 2), np.float32), ms, g)
    assert nxt.shape == (9, 2) and rew.shape == (9, 1) and term.shape == (9, 1)
    torch.testing.assert_close(ms2["propagation_indices"], ms["propagation_indices"])
    # a particle sharding over the one-process mesh steps the same particles
    from mbrl_tpu_torch.parallel import make_parallel_context

    sharding = make_parallel_context({"parallel": {"enable": True}}).particle_sharding()
    sharded = ModelEnv(tw, termination_fns.no_termination, particle_sharding=sharding)
    g = torch.Generator().manual_seed(1)
    ms_s = sharded.shard(sharded.reset(state, np.zeros((9, 2), np.float32), g))
    nxt_s, rew_s, term_s, _ = sharded.step(state, np.zeros((9, 2), np.float32), ms_s, g)
    assert torch.equal(nxt_s, nxt) and torch.equal(rew_s, rew) and torch.equal(term_s, term)


class _DummyModel:
    """Analytic dynamics: next_obs = obs + mean(act); reward = obs[0]
    (tests/test_models.py:129-154)."""

    def __init__(self, obs_dim, act_dim):
        self.in_size = obs_dim + act_dim
        self.out_size = obs_dim + 1
        self.obs_dim = obs_dim
        self.deterministic = True
        self.num_members = 1
        self.propagation_method = None
        self.device = torch.device("cpu")

    def init(self, generator):
        return {"elite": torch.arange(1)}

    def reset_1d(self, obs, generator):
        return {"obs": obs, "propagation_indices": torch.zeros(obs.shape[0], dtype=torch.int64)}

    def sample_1d(self, params, model_input, model_state, generator, deterministic=False):
        obs = model_input[:, : self.obs_dim]
        act = model_input[:, self.obs_dim :]
        new_obs = obs + act.mean(dim=1, keepdim=True)
        return torch.cat([new_obs, new_obs[:, :1]], dim=1), model_state


@pytest.mark.parametrize("num_particles", [1, 3, 5])
@pytest.mark.parametrize("horizon", [1, 4, 9])
def test_evaluate_action_sequences_analytic(num_particles, horizon):
    wrapper = TransitionRewardModel(_DummyModel(1, 2), target_is_delta=False, normalize=False)
    state = wrapper.init(torch.Generator())
    env = ModelEnv(wrapper, termination_fns.no_termination)
    a = 0.5
    values = env.evaluate_action_sequences(
        state, a * np.ones((8, horizon, 2), np.float32), np.zeros(1, np.float32),
        torch.Generator().manual_seed(0), num_particles=num_particles,
    )
    # obs_t = t*a, reward_t = obs_t => total = a * H(H+1)/2
    np.testing.assert_allclose(values.numpy(), a * horizon * (horizon + 1) / 2, rtol=1e-5)


def test_generic_path_matches_jax_expectation():
    """The generic loop (expectation propagation skips the fast path) matches
    mbrl_tpu's scan on converted weights (deterministic head: no noise)."""
    jm, tm = _pair(in_size=5, out_size=4, propagation_method="expectation", deterministic=True)
    jw = JaxTRM(jm, target_is_delta=True, learned_rewards=True)
    tw = TransitionRewardModel(tm, target_is_delta=True, learned_rewards=True)
    jstate = jw.init(jax.random.PRNGKey(3))
    tstate = convert.convert_state(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    seqs = 0.3 * np.random.default_rng(11).standard_normal((4, 3, 2)).astype(np.float32)
    obs0 = np.full(3, 0.2, np.float32)
    jv = JaxModelEnv(jw, jtf.no_termination).evaluate_action_sequences(
        jstate, seqs, obs0, jax.random.PRNGKey(0), num_particles=2)
    tv = ModelEnv(tw, termination_fns.no_termination).evaluate_action_sequences(
        tstate, seqs, obs0, torch.Generator(), num_particles=2)
    _close(jv, tv, 1e-4)
