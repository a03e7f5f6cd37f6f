"""The port's SAC learner (``mbrl_tpu_torch/planning/sac.py``) against
mbrl_tpu's on converted state, on the CPU.

Both packages step from one mid-training state (``convert.convert_sac_state``
carries the networks, log-alpha, the update counter and the three Adam states)
with the same standard normals: the JAX draws (its key splits) are fed to the
port through ``sac.normal``, the one function the port draws them with.

Tolerances (|diff| <= atol + rtol |ref|): the policy's distribution and
actions 1e-6 (float32 products of width 32 in two libraries); the
tanh-corrected log-probabilities 1e-6 in float64 (1e-4 in float32, where a
saturated tanh's 1 - y^2 cancels); losses, alpha and every parameter after
updates 1e-5 (Adam's update is lr-sized and both round in float32).
"""
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbrl_tpu.planning.sac import SAC as JaxSAC
from mbrl_tpu_torch import convert
from mbrl_tpu_torch.envs.spaces import Box
from mbrl_tpu_torch.planning import sac as sac_mod
from mbrl_tpu_torch.planning.sac import SAC, SACAgent

OBS, HID, B = 5, 32, 64
LOW, HIGH = np.array([-1.0, -2.0], np.float32), np.array([1.0, 0.5], np.float32)
ACT = len(LOW)


def _jax_sac(**kw):
    return JaxSAC(OBS, gym.spaces.Box(LOW, HIGH), hidden_size=HID, **kw)


def _port_sac(**kw):
    return SAC(OBS, Box(LOW, HIGH), hidden_size=HID, device="cpu", **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, n=B, lead=()):
    rng = np.random.default_rng(seed)
    shape = lead + (n,)
    return (rng.standard_normal(shape + (OBS,)).astype(np.float32),
            rng.uniform(LOW, HIGH, shape + (ACT,)).astype(np.float32),
            rng.standard_normal(shape + (OBS,)).astype(np.float32),
            rng.standard_normal(shape + (1,)).astype(np.float32),
            (rng.random(shape + (1,)) > 0.1).astype(np.float32))


def _jax_mid_training(jsac, updates=3):
    """A JAX state after a few updates: Adam moments and the counter are live."""
    st = jsac.init(jax.random.PRNGKey(0))
    for i in range(updates):
        st, _ = jsac.update_parameters(st, tuple(map(jnp.asarray, _batch(100 + i))),
                                       jax.random.PRNGKey(10 + i))
    return st


def _update_draws(key, n_updates=None):
    """The normals JAX draws in one update (``split`` into the critic
    target's and the policy loss's keys), or in ``update_many``'s scan."""
    if n_updates is None:
        k_next, k_pi = jax.random.split(key)
        return [jax.random.normal(k_next, (B, ACT)), jax.random.normal(k_pi, (B, ACT))]
    draws = []
    for _ in range(n_updates):
        key, k = jax.random.split(key)
        draws += _update_draws(k)
    return draws


def _feed(monkeypatch, draws):
    it = iter(draws)

    def normal(generator, shape, device):
        z = torch.from_numpy(np.array(next(it), np.float32))
        assert tuple(z.shape) == tuple(shape)
        return z

    monkeypatch.setattr(sac_mod, "normal", normal)
    return it


def _assert_close(got: torch.Tensor, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _assert_states_close(tsac, tstate, jstate, tol=1e-5):
    """Every network parameter, log-alpha, the counter and the Adam moments."""
    want = convert.convert_sac_state(tsac, _np(jstate))
    for name in ("policy", "critic", "critic_target"):
        got_sd, want_sd = getattr(tstate, name).state_dict(), getattr(want, name).state_dict()
        for k in want_sd:
            _assert_close(got_sd[k], want_sd[k].numpy(), tol, f"{name}.{k}")
    _assert_close(tstate.log_alpha, want.log_alpha.detach().numpy(), tol, "log_alpha")
    assert int(tstate.updates) == int(want.updates)
    for opt in ("policy_opt", "critic_opt"):
        module = "policy" if opt == "policy_opt" else "critic"
        got_o, want_o = getattr(tstate, opt), getattr(want, opt)
        for p, q in zip(getattr(tstate, module).parameters(), getattr(want, module).parameters()):
            for k in ("exp_avg", "exp_avg_sq"):
                _assert_close(got_o.state[p][k], want_o.state[q][k].numpy(), tol, f"{opt}.{k}")
            assert float(got_o.state[p]["step"]) == float(want_o.state[q]["step"])


def test_policy_distribution_and_tanh_correction(monkeypatch):
    jsac, tsac = _jax_sac(), _port_sac()
    jst = _jax_mid_training(jsac)
    tst = convert.convert_sac_state(tsac, _np(jst))
    obs = np.random.default_rng(1).standard_normal((B, OBS)).astype(np.float32)
    jmean, jlog_std = jsac._policy_dist(jst.policy, jnp.asarray(obs))
    tmean, tlog_std = tst.policy(torch.from_numpy(obs))
    _assert_close(tmean, jmean, 1e-6, "mean")
    _assert_close(tlog_std, jlog_std, 1e-6, "log_std")
    key = jax.random.PRNGKey(7)
    ja, jlogp, jmean_a = jsac._sample_action(jst.policy, jnp.asarray(obs), key)
    _feed(monkeypatch, [jax.random.normal(key, (B, ACT))])
    ta, tlogp, tmean_a = tsac._sample_action(tst.policy, torch.from_numpy(obs), None)
    _assert_close(ta, ja, 1e-6, "action")
    _assert_close(tmean_a, jmean_a, 1e-6, "mean action")
    # in float32 the correction log(scale (1 - y^2) + eps) cancels where tanh
    # saturates: one ulp of y (the libraries' tanh differ by ulps) moves a
    # row's log-prob by up to ~1e-5 there, so 1e-4 in float32 ...
    _assert_close(tlogp, jlogp, 1e-4, "log-prob, float32")
    assert bool(((ta >= torch.from_numpy(LOW)) & (ta <= torch.from_numpy(HIGH))).all())
    # ... and the formula itself, the same rows in float64, within 1e-6
    with jax.enable_x64(True):
        jpolicy = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                                         jst.policy)
        ja, jlogp, _ = jsac._sample_action(jpolicy, jnp.asarray(obs, jnp.float64), key)
        z = np.asarray(jax.random.normal(key, (B, ACT), jnp.float64))
        ja, jlogp = np.asarray(ja), np.asarray(jlogp)
    monkeypatch.setattr(sac_mod, "normal", lambda g, shape, device: torch.from_numpy(z))
    ta, tlogp, _ = tsac._sample_action(tst.policy.double(), torch.from_numpy(obs).double(), None)
    assert tlogp.dtype == torch.float64
    _assert_close(ta, ja, 1e-6, "action, float64")
    _assert_close(tlogp, jlogp, 1e-6, "log-prob, float64")


@pytest.mark.parametrize("auto_entropy", [True, False], ids=["tuned-alpha", "fixed-alpha"])
def test_one_update_matches(monkeypatch, auto_entropy):
    jsac = _jax_sac(automatic_entropy_tuning=auto_entropy, target_entropy=-0.5)
    tsac = _port_sac(automatic_entropy_tuning=auto_entropy, target_entropy=-0.5)
    jst = _jax_mid_training(jsac)
    tst = convert.convert_sac_state(tsac, _np(jst))
    _assert_states_close(tsac, tst, jst)  # the conversion itself
    batch, key = _batch(7), jax.random.PRNGKey(21)
    jst, jm = jsac.update_parameters(jst, tuple(map(jnp.asarray, batch)), key)
    _feed(monkeypatch, _update_draws(key))
    tst, tm = tsac.update_parameters(tst, tuple(map(torch.from_numpy, batch)), None)
    for k in ("critic_loss", "policy_loss", "alpha_loss", "alpha"):
        _assert_close(tm[k], jm[k], 1e-5, k)
    _assert_states_close(tsac, tst, jst)


def test_update_many_of_five_matches_with_a_target_interval(monkeypatch):
    jsac, tsac = _jax_sac(target_update_interval=2), _port_sac(target_update_interval=2)
    jst = _jax_mid_training(jsac)
    tst = convert.convert_sac_state(tsac, _np(jst))
    batches, key = _batch(8, lead=(5,)), jax.random.PRNGKey(22)
    jst, jm = jsac.update_many(jst, tuple(map(jnp.asarray, batches)), key)
    _feed(monkeypatch, _update_draws(key, 5))
    tst, tm = tsac.update_many(tst, tuple(map(torch.from_numpy, batches)), None)
    assert int(tst.updates) == 3 + 5
    for k in ("critic_loss", "policy_loss", "alpha_loss", "alpha"):
        _assert_close(tm[k], jm[k], 1e-5, k)
    _assert_states_close(tsac, tst, jst)


def test_target_moves_only_at_the_interval():
    tsac = _port_sac(target_update_interval=3, tau=0.5)
    tst = tsac.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    before = [p.detach().clone() for p in tst.critic_target.parameters()]
    for step in (1, 2, 3):
        tst, _ = tsac.update_parameters(tst, tuple(map(torch.from_numpy, _batch(step))), g)
        target = [p.detach() for p in tst.critic_target.parameters()]
        moved = any(not torch.equal(a, b) for a, b in zip(before, target))
        assert moved == (step == 3), step
    # at the interval: (1 - tau) target + tau critic
    for t, c, b in zip(tst.critic_target.parameters(), tst.critic.parameters(), before):
        torch.testing.assert_close(t.detach(), 0.5 * b + 0.5 * c.detach())


def test_deterministic_policy(monkeypatch):
    jsac, tsac = _jax_sac(policy="Deterministic"), _port_sac(policy="Deterministic")
    assert not tsac.automatic_entropy_tuning
    jst = _jax_mid_training(jsac, updates=2)
    tst = convert.convert_sac_state(tsac, _np(jst))
    obs = np.random.default_rng(2).standard_normal((B, OBS)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ja, jlogp, jmean = jsac._sample_action(jst.policy, jnp.asarray(obs), key)
    _feed(monkeypatch, [jax.random.normal(key, (B, ACT))])
    ta, tlogp, tmean = tsac._sample_action(tst.policy, torch.from_numpy(obs), None)
    _assert_close(ta, ja, 1e-6, "noisy action")
    _assert_close(tmean, jmean, 1e-6, "action")
    assert not tlogp.any() and tlogp.shape == (B, 1)
    # the noise is clipped to +-0.25 and the action to the space
    assert float((ta - tmean).abs().max()) <= 0.25 + 1e-6
    batch, key = _batch(9), jax.random.PRNGKey(4)
    jst, jm = jsac.update_parameters(jst, tuple(map(jnp.asarray, batch)), key)
    _feed(monkeypatch, _update_draws(key))
    tst, tm = tsac.update_parameters(tst, tuple(map(torch.from_numpy, batch)), None)
    for k in ("critic_loss", "policy_loss"):
        _assert_close(tm[k], jm[k], 1e-5, k)
    _assert_states_close(tsac, tst, jst)


def test_checkpoint_round_trip(tmp_path):
    tsac = _port_sac()
    tst = tsac.init(torch.Generator().manual_seed(0))
    tst, _ = tsac.update_many(tst, tuple(map(torch.from_numpy, _batch(5, lead=(3,)))),
                              torch.Generator().manual_seed(1))
    path = tmp_path / "sac.pkl"
    tsac.save_checkpoint(tst, path)
    loaded = tsac.load_checkpoint(path)
    a, b = tsac.state_to_host(tst), tsac.state_to_host(loaded)
    for name in ("policy", "critic", "critic_target"):
        for k in a[name]:
            np.testing.assert_array_equal(a[name][k], b[name][k])
    assert float(a["log_alpha"]) == float(b["log_alpha"]) and int(b["updates"]) == 3
    # the next update is the same from either
    batch = tuple(map(torch.from_numpy, _batch(6)))
    _, m1 = tsac.update_parameters(tst, batch, torch.Generator().manual_seed(2))
    _, m2 = tsac.update_parameters(loaded, batch, torch.Generator().manual_seed(2))
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    for p, q in zip(tst.policy.parameters(), loaded.policy.parameters()):
        assert torch.equal(p, q)


def test_load_reference_torch_checkpoint(tmp_path):
    """A pranz24-format ``sac.pth`` (built as tests/test_sac.py builds it)
    loads with ``load_state_dict``: the same policy means and Q-values as the
    torch modules it was saved from, and as mbrl_tpu's loader."""

    class TorchGaussianPolicy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.linear1 = torch.nn.Linear(OBS, HID)
            self.linear2 = torch.nn.Linear(HID, HID)
            self.mean_linear = torch.nn.Linear(HID, ACT)
            self.log_std_linear = torch.nn.Linear(HID, ACT)

        def forward(self, x):
            x = torch.relu(self.linear2(torch.relu(self.linear1(x))))
            return self.mean_linear(x), self.log_std_linear(x)

    class TorchQNetwork(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for i, (a, b) in enumerate([(OBS + ACT, HID), (HID, HID), (HID, 1)] * 2):
                setattr(self, f"linear{i + 1}", torch.nn.Linear(a, b))

        def forward(self, xu):
            q1 = self.linear3(torch.relu(self.linear2(torch.relu(self.linear1(xu)))))
            q2 = self.linear6(torch.relu(self.linear5(torch.relu(self.linear4(xu)))))
            return q1, q2

    torch.manual_seed(0)
    t_policy, t_critic, t_target = TorchGaussianPolicy(), TorchQNetwork(), TorchQNetwork()
    path = tmp_path / "sac.pth"
    torch.save({"policy_state_dict": t_policy.state_dict(),
                "critic_state_dict": t_critic.state_dict(),
                "critic_target_state_dict": t_target.state_dict()}, path)
    tsac, jsac = _port_sac(), _jax_sac()
    tst, jst = tsac.load_torch_checkpoint(path), jsac.load_torch_checkpoint(path)
    obs = np.random.default_rng(1).normal(size=(5, OBS)).astype(np.float32)
    act = np.random.default_rng(2).normal(size=(5, ACT)).astype(np.float32)
    with torch.no_grad():
        w_mean, w_log_std = t_policy(torch.from_numpy(obs))
        mean, log_std = tst.policy(torch.from_numpy(obs))
        w_q = t_critic(torch.from_numpy(np.concatenate([obs, act], 1)))
        q = tst.critic(torch.from_numpy(obs), torch.from_numpy(act))
        q_target = tst.critic_target(torch.from_numpy(obs), torch.from_numpy(act))
        w_q_target = t_target(torch.from_numpy(np.concatenate([obs, act], 1)))
    assert torch.equal(mean, w_mean)
    assert torch.equal(log_std, torch.clamp(w_log_std, -20.0, 2.0))
    assert all(torch.equal(a, b) for a, b in zip(q, w_q))
    assert all(torch.equal(a, b) for a, b in zip(q_target, w_q_target))
    j_mean, _ = jsac._policy_dist(jst.policy, jnp.asarray(obs))
    _assert_close(mean, j_mean, 1e-5, "mean vs mbrl_tpu's loader")
    assert int(tst.updates) == 0 and float(tst.log_alpha.exp()) == pytest.approx(0.2)


@pytest.mark.parametrize("refresh_age", [1, 3])
def test_agent_refresh_age(refresh_age):
    """The policy the agent acts with: the newest one the step after an
    update when refresh_age is 1; with 3, the snapshot taken at the first
    set_state since the last swap, swapped in at its third act."""
    tsac = _port_sac()
    tst = tsac.init(torch.Generator().manual_seed(0))
    agent = SACAgent(tsac, tst, seed=0, refresh_age=refresh_age)
    obs = np.random.default_rng(3).standard_normal(OBS).astype(np.float32)
    g = torch.Generator().manual_seed(1)

    def mean_action(policy):
        return tsac.act_tensor(policy, torch.from_numpy(obs)[None], g, sample=False)[0].numpy()

    snapshots = [mean_action(tst.policy)]
    acted = [agent.act(obs)]
    for step in range(1, 7):
        tst, _ = tsac.update_parameters(tst, tuple(map(torch.from_numpy, _batch(step))), g)
        snapshots.append(mean_action(tst.policy))
        agent.set_state(tst)
        acted.append(agent.act(obs))
    if refresh_age == 1:
        used = [0, 1, 2, 3, 4, 5, 6]
    else:  # snapshot 1 waits for acts 1, 2, 3; then snapshot 3 for acts 4, 5, 6
        used = [0, 0, 0, 1, 1, 1, 4]
    for t, s in enumerate(used):
        np.testing.assert_array_equal(acted[t], snapshots[s], err_msg=f"act {t}")
    # sampled actions stay inside the action space
    sampled = agent.act(np.tile(obs, (100, 1)), sample=True)
    assert sampled.shape == (100, ACT) and (sampled >= LOW).all() and (sampled <= HIGH).all()
