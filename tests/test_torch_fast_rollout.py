"""The port's shard-space fast rollout (mbrl_tpu_torch/models/fast_rollout.py)
against mbrl_tpu's, through ModelEnv.evaluate_action_sequences, on CPU.

Exact: every elite member carries the same weights and the head is
deterministic, so member assignment cannot matter and both sides must agree to
1e-4 (f32, float-sum order). Statistical: on a stochastic model, per-sequence
means over many independent rollouts agree within standard error and the
port's estimator is not noisier (the method of
tests/test_fast_rollout.py::test_full_horizon_kernel_statistical_agreement)."""
import sys

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
from mbrl_tpu_torch import convert
from mbrl_tpu_torch.envs import reward_fns, termination_fns
from mbrl_tpu_torch.envs.pets_halfcheetah import HalfCheetahEnv
from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel
from mbrl_tpu_torch.models import fast_rollout
from mbrl_tpu_torch.ops import kernels

E, ELITES, HID, ACT = 3, 2, 16, 2


def _build(obs_dim, *, learned_rewards=True, shuffle="rotate", prop="random_model",
           deterministic=False, identical=False, tight=False, hc=False, seed=0):
    """A JAX model/state and its port twin on converted weights. ``hc``: the
    PETS-HalfCheetah semantics (preprocess_fn, no_delta_list=[0], analytic
    reward)."""
    out = obs_dim + (1 if learned_rewards else 0)
    common = dict(in_size=obs_dim + ACT, out_size=out, num_layers=2, ensemble_size=E,
                  hid_size=HID, activation="silu", propagation_method=prop,
                  rollout_shuffle=shuffle, deterministic=deterministic)
    wkw = dict(target_is_delta=True, normalize=True, learned_rewards=learned_rewards,
               no_delta_list=[0] if hc else None)
    jw = JaxTRM(JaxGaussianMLP(**common),
                obs_process_fn=JaxHalfCheetah.preprocess_fn if hc else None, **wkw)
    tw = TransitionRewardModel(GaussianMLP(device="cpu", **common),
                               obs_process_fn=HalfCheetahEnv.preprocess_fn if hc else None, **wkw)
    state = jax.tree_util.tree_map(np.array, jw.init(jax.random.PRNGKey(seed)))
    params = state["params"]
    if identical:
        for leaf in [l for layer in params["layers"] for l in layer.values()]:
            leaf[:] = leaf[:1]
        for leaf in params["head"].values():
            leaf[:] = leaf[:1]
    params["layers"][0]["b"] = params["layers"][0]["b"] + 0.1
    if tight:
        params["min_logvar"] = -20.0 * np.ones_like(params["min_logvar"])
        params["max_logvar"] = -19.0 * np.ones_like(params["max_logvar"])
    params["elite"] = np.array([0, 2], np.int32)
    rng = np.random.default_rng(seed + 1)
    in_size = obs_dim + ACT
    state["normalizer"] = state["normalizer"].replace(
        mean=(0.1 * rng.standard_normal((1, in_size))).astype(np.float32),
        std=(0.5 + rng.random((1, in_size))).astype(np.float32),
    )
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    return jw, jstate, tw, convert.convert_state(state, "cpu")


def _envs(jw, tw, term=None, hc=False):
    jterm, tterm = term if term is not None else (jtf.no_termination, termination_fns.no_termination)
    jenv = JaxModelEnv(jw, jterm, reward_fn=jrf.halfcheetah if hc else None)
    tenv = ModelEnv(tw, tterm, reward_fn=reward_fns.halfcheetah if hc else None)
    return jenv, tenv


def _inputs(obs_dim, pop=4, horizon=4, seed=2):
    rng = np.random.default_rng(seed)
    seqs = (0.5 * rng.standard_normal((pop, horizon, ACT))).astype(np.float32)
    obs0 = (0.3 * rng.standard_normal(obs_dim)).astype(np.float32)
    return seqs, obs0


def _evaluate_both(jenv, jstate, tenv, tstate, seqs, obs0, particles=16):
    jv = jenv.evaluate_action_sequences(jstate, seqs, obs0, jax.random.PRNGKey(0),
                                        num_particles=particles)
    tv = tenv.evaluate_action_sequences(tstate, seqs, obs0, torch.Generator().manual_seed(0),
                                        num_particles=particles)
    return np.asarray(jv), tv.numpy()


@pytest.mark.parametrize("shuffle,prop", [("rotate", "random_model"), ("sort", "random_model"),
                                          ("sort", "fixed_model")])
def test_exact_bench_semantics(shuffle, prop):
    """Learned rewards, delta targets, normalizer: the per-step K3 path."""
    jw, jstate, tw, tstate = _build(5, shuffle=shuffle, prop=prop, deterministic=True, identical=True)
    jenv, tenv = _envs(jw, tw)
    jv, tv = _evaluate_both(jenv, jstate, tenv, tstate, *_inputs(5))
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)


def test_exact_bench_semantics_full_horizon_kernel_path(monkeypatch):
    """Stochastic head with ~e^-10 noise: the port takes the whole-horizon K1
    branch (its plain version here) and still matches mbrl_tpu's rollout."""
    calls = []
    orig = kernels.fused_rollout_returns
    monkeypatch.setattr(kernels, "fused_rollout_returns",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    jw, jstate, tw, tstate = _build(5, identical=True, tight=True)
    jenv, tenv = _envs(jw, tw)
    jv, tv = _evaluate_both(jenv, jstate, tenv, tstate, *_inputs(5))
    assert calls, "the whole-horizon kernel branch was not taken"
    np.testing.assert_allclose(tv, jv, rtol=1e-3, atol=1e-3)


def test_exact_pets_halfcheetah_semantics():
    """preprocess_fn, analytic halfcheetah reward, no_delta_list=[0], sort."""
    jw, jstate, tw, tstate = _build(6, learned_rewards=False, shuffle="sort",
                                    deterministic=True, identical=True, hc=True)
    jenv, tenv = _envs(jw, tw, hc=True)
    jv, tv = _evaluate_both(jenv, jstate, tenv, tstate, *_inputs(6))
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prop", ["random_model", "fixed_model"])
def test_exact_with_termination_that_fires(prop):
    jw, jstate, tw, tstate = _build(5, shuffle="sort", prop=prop, deterministic=True, identical=True)
    seqs, obs0 = _inputs(5, pop=8, horizon=5)
    # threshold at the median first-step obs[0]: about half the sequences stop early
    _, tenv = _envs(jw, tw)
    g = torch.Generator().manual_seed(0)
    ms = tenv.reset(tstate, np.repeat(obs0[None], 8, 0), g)
    first, *_ = tenv.step(tstate, seqs[:, 0], ms, g)
    thr = float(first[:, 0].median())

    def jterm(act, next_obs):
        return next_obs[:, :1] > thr

    def tterm(act, next_obs):
        return next_obs[:, :1] > thr

    jenv, tenv = _envs(jw, tw, term=(jterm, tterm))
    jv, tv = _evaluate_both(jenv, jstate, tenv, tstate, seqs, obs0)
    jenv_nt, _ = _envs(jw, tw)
    jv_nt, _ = _evaluate_both(jenv_nt, jstate, tenv, tstate, seqs, obs0)
    assert not np.allclose(jv, jv_nt), "the termination function never fired"
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shuffle,prop", [("rotate", "random_model"), ("sort", "random_model"),
                                          ("sort", "fixed_model")])
def test_statistical_agreement(shuffle, prop):
    """Distinct members, tight logvar bounds: what is left random is the
    member-assignment schedule, which the two packages draw differently."""
    jw, jstate, tw, tstate = _build(5, shuffle=shuffle, prop=prop, tight=True, seed=5)
    jenv, tenv = _envs(jw, tw)
    seqs, obs0 = _inputs(5, pop=4, horizon=5, seed=3)
    n_keys, particles = 32, 16
    f = jax.jit(lambda k: jenv.evaluate_action_sequences(jstate, seqs, obs0, k, num_particles=particles))
    vals_j = np.stack([np.asarray(f(k)) for k in jax.random.split(jax.random.PRNGKey(2), n_keys)])
    g = torch.Generator().manual_seed(2)
    vals_t = np.stack([
        tenv.evaluate_action_sequences(tstate, seqs, obs0, g, num_particles=particles).numpy()
        for _ in range(n_keys)
    ])
    mean_j, mean_t = vals_j.mean(0), vals_t.mean(0)
    var_j, var_t = vals_j.var(0), vals_t.var(0)
    se = np.sqrt((var_j + var_t) / n_keys) + 1e-6
    np.testing.assert_array_less(np.abs(mean_t - mean_j), 5.0 * se + 1e-3)
    assert float(var_t.mean()) <= 1.5 * float(var_j.mean()) + 1e-6, (var_t.mean(), var_j.mean())


@pytest.mark.parametrize("shuffle,prop", [("rotate", "random_model"), ("sort", "random_model"),
                                          ("sort", "fixed_model")])
def test_statistical_agreement_deterministic_head(shuffle, prop):
    """The per-step K3 path on distinct members: the member-assignment
    schedule is all that is random."""
    jw, jstate, tw, tstate = _build(5, shuffle=shuffle, prop=prop, deterministic=True, seed=7)
    jenv, tenv = _envs(jw, tw)
    seqs, obs0 = _inputs(5, pop=4, horizon=5, seed=4)
    n_keys, particles = 32, 16
    f = jax.jit(lambda k: jenv.evaluate_action_sequences(jstate, seqs, obs0, k, num_particles=particles))
    vals_j = np.stack([np.asarray(f(k)) for k in jax.random.split(jax.random.PRNGKey(3), n_keys)])
    g = torch.Generator().manual_seed(3)
    vals_t = np.stack([
        tenv.evaluate_action_sequences(tstate, seqs, obs0, g, num_particles=particles).numpy()
        for _ in range(n_keys)
    ])
    se = np.sqrt((vals_j.var(0) + vals_t.var(0)) / n_keys) + 1e-6
    np.testing.assert_array_less(np.abs(vals_t.mean(0) - vals_j.mean(0)), 5.0 * se + 1e-3)
    assert float(vals_t.var(0).mean()) <= 1.5 * float(vals_j.var(0).mean()) + 1e-6


@pytest.mark.parametrize("hid", [16, 248])
def test_deterministic_head_rollout_width_gate(monkeypatch, hid):
    """A deterministic head steps through the K3 wrapper, one call a step, at
    a narrow and at a wide model; both match mbrl_tpu's rollout on an
    identical-member model."""
    monkeypatch.setattr(sys.modules[__name__], "HID", hid)
    calls = []
    orig = kernels.fused_ensemble_mlp
    monkeypatch.setattr(kernels, "fused_ensemble_mlp",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    jw, jstate, tw, tstate = _build(5, shuffle="sort", deterministic=True, identical=True)
    jenv, tenv = _envs(jw, tw)
    seqs, obs0 = _inputs(5, horizon=3)
    jv, tv = _evaluate_both(jenv, jstate, tenv, tstate, seqs, obs0)
    assert len(calls) == 3
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)


def test_fold_normalizer_exact():
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.standard_normal((3, 7, 5)).astype(np.float32))
    b0 = torch.from_numpy(rng.standard_normal((3, 1, 5)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 11, 7)).astype(np.float32))
    mu = torch.from_numpy(rng.standard_normal((1, 7)).astype(np.float32))
    sd = torch.from_numpy((np.abs(rng.standard_normal((1, 7))) + 0.5).astype(np.float32))

    class Stats:
        mean = mu
        std = sd

    class W:
        normalize = True

    w0f, b0f = fast_rollout._fold_normalizer(W(), {"normalizer": Stats()}, w0, b0)
    direct = torch.bmm((x - mu) / sd, w0) + b0
    folded = torch.bmm(x, w0f) + b0f
    torch.testing.assert_close(folded, direct, atol=1e-4, rtol=1e-4)


def test_fast_rollout_gate():
    _, _, tw, tstate = _build(5)
    assert fast_rollout.supports_fast_rollout(tw, tstate, batch=8 * ELITES)
    assert not fast_rollout.supports_fast_rollout(tw, tstate, batch=8 * ELITES + 1)
    tw.model.propagation_method = "expectation"
    assert not fast_rollout.supports_fast_rollout(tw, tstate, batch=8 * ELITES)
    assert fast_rollout._is_trivial_termination(termination_fns.no_termination)
    assert not fast_rollout._is_trivial_termination(termination_fns.hopper)


def test_bfloat16_rollout_close_to_f32():
    """compute_dtype="bfloat16" through the K1 branch stays within bf16
    rounding of the f32 rollout and returns f32."""
    _, _, tw, tstate = _build(5, identical=True, tight=True)
    seqs, obs0 = _inputs(5)
    env = ModelEnv(tw, termination_fns.no_termination)
    v32 = env.evaluate_action_sequences(tstate, seqs, obs0, torch.Generator().manual_seed(0), 16)
    tw.model.compute_dtype = torch.bfloat16
    v16 = env.evaluate_action_sequences(tstate, seqs, obs0, torch.Generator().manual_seed(0), 16)
    assert v16.dtype == torch.float32
    torch.testing.assert_close(v16, v32, atol=5e-2, rtol=5e-2)
