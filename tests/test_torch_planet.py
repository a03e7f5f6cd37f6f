"""The port's PlaNet model (``mbrl_tpu_torch/models/planet.py``), its trainer
routes and its latent planning against mbrl_tpu's, on the CPU
(``algorithms/planet.py`` is in ``test_torch_planet_algorithm.py``).

Both packages get the same params (numpy, the JAX layout; biases redrawn
nonzero) and the same numpy-seeded pixel windows, at ``tests/test_planet.py``'s
sizes and at ``dynamics_model/planet.yaml``'s full width (B = 2, L = 4).

Tolerances (|port - jax| <= tol * max |jax| of the compared array): the
deterministic unroll, ``eval_score`` and its gradient 1e-5 (float32 products
of up to 4,096 terms in two libraries); the stochastic loss and its gradient
with JAX's own normals fed through the port's noise seam 1e-4 (the free-nats
clamp and the sampled latents compound the rounding); one
``train_device_sequences`` step from one state, with JAX's windows and
normals, 1e-4 absolute on every parameter (Adam moves each by at most its
learning rate, 1e-3). Where the random streams differ, the samples agree
statistically: equal means within 4.5 standard errors, variance ratios
within 0.85-1.18 at 4,000 draws.
"""
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbrl_tpu.models import ModelEnv as JaxModelEnv
from mbrl_tpu.models import ModelTrainer as JaxModelTrainer
from mbrl_tpu.models import PlaNetModel as JaxPlaNet
from mbrl_tpu.envs.termination_fns import no_termination as jax_no_termination
from mbrl_tpu.ops.math import quantize_obs as jax_quantize_obs
from mbrl_tpu.types import TransitionBatch as JaxBatch
from mbrl_tpu.util.device_buffer import DeviceTransitionDataset as JaxDataset
from mbrl_tpu.util.replay_buffer import ReplayBuffer as JaxReplayBuffer
from mbrl_tpu_torch import convert
from mbrl_tpu_torch.algorithms import planet as planet_algo
from mbrl_tpu_torch.envs.spaces import Box
from mbrl_tpu_torch.envs.termination_fns import no_termination
from mbrl_tpu_torch.models import ModelEnv, ModelTrainer, PlaNetModel
from mbrl_tpu_torch.models import trainer as trainer_mod
from mbrl_tpu_torch.models.fast_rollout import supports_fast_rollout
from mbrl_tpu_torch.ops.math import quantize_obs
from mbrl_tpu_torch.ops.tree import tree_leaves_with_path, tree_map
from mbrl_tpu_torch.types import TransitionBatch
from mbrl_tpu_torch.util.device_buffer import DeviceTransitionDataset
from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = REPO / "mbrl_tpu_torch" / "examples" / "conf"

# tests/test_planet.py's sizes
OBS_SHAPE = (3, 32, 32)
ENC_CFG = [(3, 8, 4, 2), (8, 16, 4, 2)]
DEC_CFG = [(64, 1, 1), [(64, 32, 5, 1), (32, 16, 6, 2), (16, 3, 6, 2)]]
LATENT, BELIEF, ACT = 6, 16, 2
SMALL = dict(obs_shape=OBS_SHAPE, obs_encoding_size=64, encoder_config=ENC_CFG,
             decoder_config=DEC_CFG, latent_state_size=LATENT, action_size=ACT,
             belief_size=BELIEF, hidden_size_fcs=32)
# dynamics_model/planet.yaml, action size 6 (cheetah)
FULL = dict(obs_shape=(3, 64, 64), obs_encoding_size=1024,
            encoder_config=[(3, 32, 4, 2), (32, 64, 4, 2), (64, 128, 4, 2), (128, 256, 4, 2)],
            decoder_config=[(1024, 1, 1), [(1024, 128, 5, 2), (128, 64, 5, 2), (64, 32, 6, 2),
                                           (32, 3, 6, 2)]],
            latent_state_size=30, action_size=6, belief_size=200, hidden_size_fcs=200)
SIZES = {"small": (SMALL, 3, 6), "full": (FULL, 2, 4)}  # config, B, L


def _models(kw):
    return JaxPlaNet(**kw), PlaNetModel(**kw, device="cpu")


def _np_params(model: PlaNetModel, seed: int):
    """Params of ``model``'s layout as numpy: the port's init, biases redrawn
    nonzero so that nothing cancels."""
    params = model.init(torch.Generator().manual_seed(seed))["params"]
    rng = np.random.default_rng(seed)
    out = tree_map(lambda t: t.numpy().copy(), params)
    for path, leaf in tree_leaves_with_path(out):
        if path[-1] in ("b", "b_ih", "b_hh"):
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    return out


def _states(jm, tm, seed=0):
    params = _np_params(tm, seed)
    posterior = {"latent": np.zeros((1, tm.latent_state_size), np.float32),
                 "belief": np.zeros((1, tm.belief_size), np.float32)}
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, params), "normalizer": None,
              "posterior": jax.tree_util.tree_map(jnp.asarray, posterior)}
    tstate = convert.convert_planet_state({"params": params, "posterior": posterior}, "cpu")
    return jstate, tstate


def _windows(obs_shape, act, b, length, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 255, (b, length) + tuple(obs_shape)).astype(np.uint8)
    acts = rng.uniform(-1, 1, (b, length, act)).astype(np.float32)
    rew = rng.standard_normal((b, length)).astype(np.float32)
    flags = np.zeros((b, length), bool)
    return (JaxBatch(obs, acts, obs, rew, flags, flags),
            TransitionBatch(*(torch.as_tensor(x) for x in (obs, acts, obs, rew, flags, flags))))


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _grad_state(tstate):
    """The port state with fresh params that require grad."""
    return {**tstate, "params": tree_map(lambda t: t.detach().clone().requires_grad_(True),
                                         tstate["params"])}


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted), tensors as numpy."""
    return jax.tree_util.tree_leaves(
        tree_map(lambda t: t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
                 tree))


def _compare_grads(jgrads, params, tol):
    got = _leaves(tree_map(lambda t: t.grad, params))
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, tol, "gradient")


def _jax_normals(key, b, length, latent):
    """The posterior and prior normals JAX's unroll draws from ``key``
    (mbrl_tpu/models/planet.py:233-247): per step, key -> (key, k_post, k_prior)."""
    post, prior = [], []
    for _ in range(length):
        key, k_post, k_prior = jax.random.split(key, 3)
        post.append(np.asarray(jax.random.normal(k_post, (b, latent))))
        prior.append(np.asarray(jax.random.normal(k_prior, (b, latent))))
    return np.stack(post, 1), np.stack(prior, 1)


# --------------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------------- #
def test_convert_planet_state_keeps_every_array():
    """The JAX init's tree (traced abstractly: its eager init takes seconds)
    is the port's, and the converter changes no array."""
    jm, tm = _models(SMALL)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jstate, tstate = _states(jm, tm, seed=0)
    assert jax.tree_util.tree_structure(shapes["params"]) == \
        jax.tree_util.tree_structure(jstate["params"])
    assert [s.shape for s in jax.tree_util.tree_leaves(shapes["params"])] == \
        [a.shape for a in _leaves(tstate["params"])]
    jl, tl = _leaves(jstate["params"]), _leaves(tstate["params"])
    assert len(jl) == len(tl) == 34 and all(np.array_equal(a, b) for a, b in zip(jl, tl))
    assert tstate["posterior"]["belief"].shape == (1, BELIEF)
    bad = tree_map(lambda t: t.numpy(), tstate["params"])
    bad["belief_gru"]["w_hh"] = bad["belief_gru"]["w_hh"].T[:, :BELIEF]
    with pytest.raises(ValueError, match="belief_gru"):
        convert.convert_planet_params(bad, "cpu")


@pytest.mark.parametrize("size", ["small", "full"])
def test_deterministic_unroll_eval_score_and_gradient_match_jax(size):
    kw, b, length = SIZES[size]
    jm, tm = _models(kw)
    jstate, tstate = _states(jm, tm, seed=1)
    jb, tb = _windows(kw["obs_shape"], kw["action_size"], b, length, seed=2)

    obs = jm._process_pixel_obs(jnp.asarray(jb.obs))
    want = jm.unroll(jstate["params"], obs[:, 1:], jnp.asarray(jb.act[:, :-1]),
                     jax.random.PRNGKey(0), deterministic=True)
    got = tm.unroll(tstate["params"], tm._process_pixel_obs(tb.obs)[:, 1:], tb.act[:, :-1],
                    deterministic=True)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-5, k)

    score_j, meta_j = jm.eval_score(jstate, jb)
    score_t, meta_t = tm.eval_score(tstate, tb)
    assert score_t.shape == (1, b, 1)
    _close(score_t, score_j, 1e-5, "eval_score")
    for k in meta_j:
        _close(meta_t[k], meta_j[k], 1e-5, k)

    def jscore(params):
        return jm.eval_score({**jstate, "params": params}, jb)[0].sum()

    jgrads = jax.grad(jscore)(jstate["params"])
    gstate = _grad_state(tstate)
    tm.eval_score(gstate, tb)[0].sum().backward()
    _compare_grads(jgrads, gstate["params"], 1e-5)


@pytest.mark.parametrize("size", ["small", "full"])
def test_loss_and_gradient_with_jax_normals_match_jax(size):
    kw, b, length = SIZES[size]
    jm, tm = _models(kw)
    jstate, tstate = _states(jm, tm, seed=3)
    jb, tb = _windows(kw["obs_shape"], kw["action_size"], b, length, seed=4)
    key = jax.random.PRNGKey(5)
    post, prior = _jax_normals(key, b, length - 1, kw["latent_state_size"])

    def jloss(params):
        return jm.loss({**jstate, "params": params}, jb, key=key)

    (loss_j, meta_j), jgrads = jax.value_and_grad(jloss, has_aux=True)(jstate["params"])
    gstate = _grad_state(tstate)
    loss_t, meta_t = tm.loss(gstate, tb, post_noise=torch.as_tensor(post),
                             prior_noise=torch.as_tensor(prior))
    _close(loss_t, loss_j, 1e-4, "loss")
    for k in meta_j:
        _close(meta_t[k], meta_j[k], 1e-4, k)
    assert float(meta_t["kl_loss"]) >= tm.free_nats - 1e-5
    loss_t.backward()
    _compare_grads(jgrads, gstate["params"], 1e-4)


def test_sample_and_update_posterior_match_jax():
    jm, tm = _models(SMALL)
    jstate, tstate = _states(jm, tm, seed=6)
    rng = np.random.default_rng(7)
    obs = rng.integers(0, 255, OBS_SHAPE).astype(np.uint8)
    act = rng.uniform(-1, 1, ACT).astype(np.float32)

    j1 = jm.update_posterior(jstate, obs, action=None, key=jax.random.PRNGKey(1))
    t1 = tm.update_posterior(tstate, obs, action=None, generator=torch.Generator().manual_seed(1))
    _close(t1["posterior"]["belief"], j1["posterior"]["belief"], 1e-6, "first belief")
    # carry the JAX posterior over, so that the next belief is a function of
    # the same (s, h, a, o) in both
    t1 = {**t1, "posterior": {k: torch.as_tensor(np.asarray(v))
                              for k, v in j1["posterior"].items()}}
    j2 = jm.update_posterior(j1, obs, action=act, key=jax.random.PRNGKey(2))
    t2 = tm.update_posterior(t1, obs, action=act, generator=torch.Generator().manual_seed(2))
    _close(t2["posterior"]["belief"], j2["posterior"]["belief"], 1e-6, "belief")
    assert t2["posterior"]["latent"].shape == (1, LATENT)
    assert not torch.equal(t2["posterior"]["latent"], t1["posterior"]["latent"])

    # one deterministic prior step from the tracked posterior, 5 particles
    acts = rng.uniform(-1, 1, (5, ACT)).astype(np.float32)
    jms = jm.reset(j2, jnp.zeros((5,) + OBS_SHAPE), jax.random.PRNGKey(3))
    t2 = {**t2, "posterior": {k: torch.as_tensor(np.asarray(v))
                              for k, v in j2["posterior"].items()}}
    tms = tm.reset(t2, torch.zeros((5,) + OBS_SHAPE), torch.Generator())
    jl, jr, jn = jm.sample(j2, jnp.asarray(acts), jms, jax.random.PRNGKey(4), deterministic=True)
    tl, tr, tn = tm.sample(t2, torch.as_tensor(acts), tms, torch.Generator(), deterministic=True)
    _close(tl, jl, 1e-5, "latent")
    _close(tr, jr, 1e-5, "reward")
    _close(tn["belief"], jn["belief"], 1e-5, "belief")

    img = tm.render(t2, tn["latent"], tn["belief"])
    assert img.shape == (5, 32, 32, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, jm.render(j2, jn["latent"], jn["belief"]))
    reset = tm.reset_posterior(t2)
    assert not reset["posterior"]["latent"].any() and not reset["posterior"]["belief"].any()


def _agree(port: np.ndarray, ref: np.ndarray, what: str):
    """Means within 4.5 standard errors and variances within 0.85-1.18, per
    column of (N, ...) draws."""
    port, ref = port.reshape(len(port), -1), ref.reshape(len(ref), -1)
    n = len(port)
    se = np.sqrt(port.var(0) / n + ref.var(0) / n)
    assert np.all(np.abs(port.mean(0) - ref.mean(0)) <= 4.5 * se + 1e-7), what
    ratio = port.var(0) / ref.var(0)
    assert np.all((ratio > 0.85) & (ratio < 1.18)), (what, ratio.min(), ratio.max())


def test_posterior_and_prior_samples_agree_statistically():
    """4,000 copies of one window: the stochastic unroll's posterior and prior
    samples at the last step, and the learned returns of 4,000 copies of one
    action sequence through ModelEnv's latent rollout (the prior's draws)."""
    n = 4000
    jm, tm = _models(SMALL)
    jstate, tstate = _states(jm, tm, seed=8)
    jb, _ = _windows(OBS_SHAPE, ACT, 1, 5, seed=9)
    obs = np.repeat(np.asarray(jm._process_pixel_obs(jnp.asarray(jb.obs))), n, axis=0)
    acts = np.repeat(jb.act, n, axis=0)
    want = jm.unroll(jstate["params"], jnp.asarray(obs[:, 1:]), jnp.asarray(acts[:, :-1]),
                     jax.random.PRNGKey(10))
    got = tm.unroll(tstate["params"], torch.as_tensor(obs[:, 1:]), torch.as_tensor(acts[:, :-1]),
                    generator=torch.Generator().manual_seed(10))
    for k in ("post_sample", "prior_sample"):
        _agree(got[k][:, -1].detach().numpy(), np.asarray(want[k][:, -1]), k)

    # latent planning returns: ModelEnv's per-step loop over sample()
    frame = jb.obs[0, 0]
    jstate = jm.update_posterior(jstate, frame, key=jax.random.PRNGKey(11))
    tstate = {**tstate, "posterior": {k: torch.as_tensor(np.asarray(v))
                                      for k, v in jstate["posterior"].items()}}
    seqs = np.repeat(np.random.default_rng(12).uniform(-1, 1, (1, 4, ACT)), n, 0).astype(np.float32)
    ref = JaxModelEnv(jm, jax_no_termination, None).evaluate_action_sequences(
        jstate, jnp.asarray(seqs), jnp.asarray(frame, jnp.float32), jax.random.PRNGKey(13),
        num_particles=1)
    env = ModelEnv(tm, no_termination, None)
    assert not supports_fast_rollout(tm, tstate, n)
    with torch.no_grad():
        values = env.evaluate_action_sequences(tstate, seqs, frame, torch.Generator().manual_seed(13),
                                               num_particles=1)
    assert values.shape == (n,)
    _agree(values.numpy(), np.asarray(ref), "returns")


class MockPixelEnv:
    """tests/test_planet.py's pixel env without gymnasium: image brightness
    encodes a scalar state pushed by the actions."""

    def __init__(self):
        self.observation_space = Box(0, 255, shape=OBS_SHAPE, dtype=np.uint8)
        self.action_space = Box(-np.ones(ACT), np.ones(ACT), dtype=np.float32, seed=0)
        self.t = 0
        self.x = 0.5

    def _obs(self):
        return np.full(OBS_SHAPE, np.uint8(np.clip(self.x, 0, 1) * 255), dtype=np.uint8)

    def reset(self, seed=None, options=None):
        self.t = 0
        self.x = 0.5
        return self._obs(), {}

    def step(self, action):
        self.x = float(np.clip(self.x + 0.05 * np.mean(action), 0, 1))
        self.t += 1
        return self._obs(), 1.0 - abs(self.x - 0.8), False, self.t >= 10, {}


def _mock_buffers(trajectories=4, trial=10, seed=0):
    """A JAX and a port replay buffer holding the same MockPixelEnv
    trajectories (random actions)."""
    env = MockPixelEnv()
    rng = np.random.default_rng(seed)
    kw = dict(obs_type=np.uint8, max_trajectory_length=trial + 2)
    jrb = JaxReplayBuffer(1000, OBS_SHAPE, (ACT,), rng=np.random.default_rng(0), **kw)
    trb = ReplayBuffer(1000, OBS_SHAPE, (ACT,), rng=np.random.default_rng(0), **kw)
    for _ in range(trajectories):
        obs, _ = env.reset()
        done = trunc = False
        while not (done or trunc):
            act = rng.uniform(-1, 1, ACT).astype(np.float32)
            next_obs, r, done, trunc, _ = env.step(act)
            for rb in (jrb, trb):
                rb.add(obs, act, next_obs, r, done, trunc)
            obs = next_obs
    return jrb, trb


def test_train_device_sequences_step_matches_jax(monkeypatch):
    """One update from one state: the JAX program's window starts and normals
    (its key splits, mbrl_tpu/models/trainer.py:703-707) fed to the port."""
    jm, tm = _models(SMALL)
    jstate, tstate = _states(jm, tm, seed=14)
    jrb, trb = _mock_buffers()
    length, b = 5, 4
    starts = planet_algo.valid_window_starts(trb.trajectory_indices, length)
    jds = JaxDataset(OBS_SHAPE, ACT, obs_dtype=np.uint8, min_capacity=256)
    jds.sync_from(jrb)
    tds = DeviceTransitionDataset(OBS_SHAPE, ACT, min_capacity=256, obs_dtype=torch.uint8,
                                  device="cpu")
    tds.sync_from(trb)
    assert tds.data.obs.dtype == torch.uint8
    np.testing.assert_array_equal(tds.data.obs[: trb.num_stored].numpy(),
                                  np.asarray(jds.data.obs)[: trb.num_stored])

    key = jax.random.PRNGKey(15)
    _, k_idx, k_loss = jax.random.split(key, 3)
    pos = np.asarray(jax.random.randint(k_idx, (b,), 0, len(starts)))
    post, prior = _jax_normals(k_loss, b, length - 1, LATENT)
    jmetas = []
    jnew, jlosses = JaxModelTrainer(jm, optim_lr=1e-3, optim_eps=1e-4).train_device_sequences(
        jstate, jds, starts.astype(np.int32), num_updates=1, batch_size=b, seq_len=length,
        key=key, batch_callback=lambda *a: jmetas.append(a[2]))

    monkeypatch.setattr(trainer_mod, "randint", lambda *a, **k: torch.as_tensor(pos))
    loss = tm.loss
    monkeypatch.setattr(tm, "loss", lambda state, batch, generator=None: loss(
        state, batch, post_noise=torch.as_tensor(post), prior_noise=torch.as_tensor(prior)))
    tmetas = []
    tnew, tlosses = ModelTrainer(tm, optim_lr=1e-3, optim_eps=1e-4).train_device_sequences(
        tstate, tds, starts, num_updates=1, batch_size=b, seq_len=length,
        generator=torch.Generator(), batch_callback=lambda *a: tmetas.append(a[2]))

    np.testing.assert_allclose(tlosses, np.asarray(jlosses), rtol=1e-4)
    for k in ("observations_loss", "reward_loss", "kl_loss", "grad_norm"):
        np.testing.assert_allclose(tmetas[0][k], float(jmetas[0][k]), rtol=1e-4, err_msg=k)
    jl, tl = _leaves(jnew["params"]), _leaves(tnew["params"])
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        np.testing.assert_allclose(t, a, atol=1e-4, rtol=0)
    assert "opt_state" in tnew
    assert not any(t.requires_grad for _, t in tree_leaves_with_path(tnew["params"]))


def test_device_sequence_training_reduces_loss():
    """tests/test_planet.py's device-training case on the port: 24 updates of
    8 windows of 5 rows, losses falling, finite params, Adam state kept."""
    tm = PlaNetModel(**SMALL, device="cpu")
    state = tm.init(torch.Generator().manual_seed(0))
    _, trb = _mock_buffers(seed=1)
    starts = planet_algo.valid_window_starts(trb.trajectory_indices, 5)
    for s in starts:
        assert any(lo <= s and s + 5 <= hi for lo, hi in trb.trajectory_indices)
    ds = DeviceTransitionDataset(OBS_SHAPE, ACT, min_capacity=256, obs_dtype=torch.uint8,
                                 device="cpu")
    ds.sync_from(trb)
    trainer = ModelTrainer(tm, optim_lr=1e-3)
    new_state, losses = trainer.train_device_sequences(
        state, ds, starts, num_updates=24, batch_size=8, seq_len=5,
        generator=torch.Generator().manual_seed(0))
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
    assert "opt_state" in new_state
    assert all(bool(torch.isfinite(t).all()) for _, t in tree_leaves_with_path(new_state["params"]))
    with pytest.raises(ValueError, match="window"):
        trainer.train_device_sequences(state, ds, starts[:0], num_updates=1, batch_size=8,
                                       seq_len=5)


def test_host_route_training_passes_the_generator_and_the_loss_meta():
    """ModelTrainer.train on a stacked sequence batch: the stochastic loss
    gets the call's generator (one seed, one result) and batch_callback gets
    the loss meta with the pre-clip gradient norm."""
    tm = PlaNetModel(**SMALL, device="cpu")
    state = tm.init(torch.Generator().manual_seed(0))
    _, tb = _windows(OBS_SHAPE, ACT, 4, 5, seed=16)
    stacked = tb.map(lambda x: torch.stack([x] * 2))
    runs = []
    for _ in range(2):
        metas = []
        new, losses, _ = ModelTrainer(tm, optim_lr=3e-4, optim_eps=1e-4).train(
            state, stacked, num_epochs=1, evaluate=False,
            generator=torch.Generator().manual_seed(3),
            batch_callback=lambda e, l, m, kind: metas.append(m))
        runs.append((losses, metas))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == 8  # 2 batches, padded to 8 steps
    assert set(runs[0][1][0]) == {"observations_loss", "reward_loss", "kl_loss", "grad_norm"}
    assert all(np.isfinite(list(m.values())).all() for m in runs[0][1])


def test_planet_keeps_the_callers_tf32_flags():
    """Every product of the model runs in full float32 (the flags are off
    inside its forward and the trainer's backward), and the caller's flags
    come back after it, an exception included."""
    tm = PlaNetModel(**SMALL, device="cpu")
    state = tm.init(torch.Generator().manual_seed(0))
    _, tb = _windows(OBS_SHAPE, ACT, 2, 4, seed=17)
    seen = []
    apply = tm.encoder.apply

    def spy(params, obs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
        return apply(params, obs)

    tm.encoder.apply = spy
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        ModelTrainer(tm).train(state, tb.map(lambda x: x[None]), num_epochs=1, evaluate=False)
        tm.update_posterior(state, tb.obs[0, 0].numpy())
        assert seen and all(s == (False, "highest") for s in seen)
        assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == (True, "high")
        with pytest.raises(RuntimeError):
            with tm.precision():
                raise RuntimeError
        assert (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()) == (True, "high")
        assert PlaNetModel(**SMALL, matmul_precision="default", device="cpu").precision() \
            .__class__.__name__ == "nullcontext"
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(matmul)


def test_save_and_load_are_interchangeable_with_jax(tmp_path):
    jm, tm = _models(SMALL)
    jstate, tstate = _states(jm, tm, seed=18)
    tm.save(tstate, tmp_path)
    loaded_j = jm.load(jstate, tmp_path)
    for a, t in zip(_leaves(loaded_j["params"]), _leaves(tstate["params"])):
        np.testing.assert_array_equal(a, t)
    (tmp_path / "jax").mkdir()
    jm.save(jstate, tmp_path / "jax")
    loaded_t = tm.load(tm.init(torch.Generator()), tmp_path / "jax")
    for a, t in zip(_leaves(jstate["params"]), _leaves(loaded_t["params"])):
        np.testing.assert_array_equal(a, t)
    with open(tmp_path / "planet.pkl", "rb") as f:
        assert isinstance(pickle.load(f)["belief_gru"]["w_ih"], np.ndarray)


def test_quantize_obs_matches_jax():
    obs = np.array([[0, 17, 255, 128]], np.uint8)
    want = np.asarray(jax_quantize_obs(jnp.asarray(obs, jnp.int32), 5))
    got = quantize_obs(torch.as_tensor(obs), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.uint8
    noisy = quantize_obs(torch.as_tensor(obs), 5, generator=torch.Generator().manual_seed(0),
                         add_noise=True)
    assert noisy.dtype == torch.float32
    assert bool(((noisy >= got) & (noisy < got.float() + 8)).all())
    assert not torch.equal(noisy, got.float())
    with pytest.raises(ValueError, match="generator"):
        quantize_obs(torch.as_tensor(obs), 5, add_noise=True)
