"""The port's training slice against mbrl_tpu on converted weights (CPU, small
sizes): GaussianMLP.loss, TransitionRewardModel.loss/eval_score/process_batch,
gradients, and ModelTrainer on both routes.

Inputs come from numpy and go through both sides. Tolerances: losses, scores
and processed batches 1e-5; gradients 1e-4 relative to each leaf's largest
entry; three trainer epochs 1e-4 relative per epoch loss and 1e-3 on the final
parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbrl_tpu.models import GaussianMLP as JaxGaussianMLP
from mbrl_tpu.models import ModelTrainer as JaxModelTrainer
from mbrl_tpu.models import TransitionRewardModel as JaxTRM
from mbrl_tpu.models import trainer as jax_trainer
from mbrl_tpu.types import TransitionBatch as JaxTransitionBatch
from mbrl_tpu_torch import convert
from mbrl_tpu_torch.envs import termination_fns
from mbrl_tpu_torch.models import (
    DivergenceError, GaussianMLP, ModelEnv, ModelTrainer, TransitionRewardModel,
)
from mbrl_tpu_torch.models import trainer as torch_trainer
from mbrl_tpu_torch.ops.tree import tree_leaves_with_path, tree_map
from mbrl_tpu_torch.types import TransitionBatch
from mbrl_tpu_torch.util.device_buffer import DeviceTransitionDataset
from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

OBS, ACT, E, HID = 3, 2, 4, 32


def _pair(deterministic=False, learned_rewards=True, no_delta_list=None, target_is_delta=True,
          num_elites=2, **kw):
    common = dict(in_size=OBS + ACT, out_size=OBS + int(learned_rewards), num_layers=2,
                  ensemble_size=E, hid_size=HID, activation="silu", deterministic=deterministic)
    common.update(kw)
    wkw = dict(target_is_delta=target_is_delta, normalize=True, learned_rewards=learned_rewards,
               no_delta_list=no_delta_list, num_elites=num_elites)
    jw = JaxTRM(JaxGaussianMLP(**common), **wkw)
    tw = TransitionRewardModel(GaussianMLP(device="cpu", **common), **wkw)
    return jw, tw


def _states(jw, seed=0):
    """A JAX state with non-trivial biases, logvar bounds and normalizer, and
    the same state carried across."""
    rng = np.random.default_rng(seed)
    jstate = jw.init(jax.random.PRNGKey(seed))
    p = jstate["params"]
    for layer in p["layers"] + [p["head"]]:
        layer["b"] = jnp.asarray(0.1 * rng.standard_normal(layer["b"].shape), jnp.float32)
    data = (rng.standard_normal((64, OBS + ACT)) * 2 + 0.5).astype(np.float32)
    from mbrl_tpu.ops import normalizer as jnrm

    jstate["normalizer"] = jnrm.update_stats(jstate["normalizer"], jnp.asarray(data))
    host = jax.tree_util.tree_map(np.asarray, jstate)
    return jstate, convert.convert_state(host, "cpu")


def _batch(shape, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(shape + s).astype(np.float32)
    obs, act = f(OBS), f(ACT)
    next_obs = obs + 0.1 * act.sum(-1, keepdims=True) + 0.01 * f(OBS)
    rewards = obs[..., 0] + 0.01 * f()
    flags = np.zeros(shape, bool)
    return (obs, act, next_obs, rewards, flags, flags)


def _both(arrays):
    return JaxTransitionBatch(*arrays), TransitionBatch(*arrays)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b, np.float32), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("lifted", [False, True])
def test_gaussian_mlp_loss_matches_jax(deterministic, lifted):
    jw, tw = _pair(deterministic=deterministic)
    jstate, tstate = _states(jw)
    rng = np.random.default_rng(2)
    shape = (7,) if lifted else (E, 7)
    x = rng.standard_normal(shape + (OBS + ACT,)).astype(np.float32)
    y = rng.standard_normal(shape + (OBS + 1,)).astype(np.float32)
    jl, _ = jw.model.loss(jstate["params"], jnp.asarray(x), jnp.asarray(y))
    tl, meta = tw.model.loss(tstate["params"], torch.from_numpy(x), torch.from_numpy(y))
    assert meta == {} and tl.ndim == 0
    _close(tl.detach(), jl, 1e-5)
    js, _ = jw.model.eval_score(jstate["params"], jnp.asarray(x), jnp.asarray(y))
    ts, _ = tw.model.eval_score(tstate["params"], torch.from_numpy(x), torch.from_numpy(y))
    assert ts.shape == (E, 7, OBS + 1) and not ts.requires_grad
    _close(ts, js, 1e-5)


@pytest.mark.parametrize("learned_rewards", [True, False])
@pytest.mark.parametrize("no_delta_list", [None, [0, 2]])
@pytest.mark.parametrize("target_is_delta", [True, False])
def test_transition_model_loss_and_batch_match_jax(learned_rewards, no_delta_list, target_is_delta):
    jw, tw = _pair(learned_rewards=learned_rewards, no_delta_list=no_delta_list,
                   target_is_delta=target_is_delta)
    jstate, tstate = _states(jw)
    jb, tb = _both(_batch((E, 9)))
    jin, jtarget = jw.process_batch(jstate, jb)
    tin, ttarget = tw.process_batch(tstate, tb)
    assert tin.dtype == torch.float32 and ttarget.shape == (E, 9, OBS + int(learned_rewards))
    _close(tin, jin)
    _close(ttarget, jtarget)
    _close(tw.loss(tstate, tb)[0].detach(), jw.loss(jstate, jb)[0])
    _close(tw.eval_score(tstate, tb)[0], jw.eval_score(jstate, jb)[0])
    # a flat (B, ...) batch is broadcast to every member
    jb, tb = _both(_batch((9,)))
    _close(tw.loss(tstate, tb)[0].detach(), jw.loss(jstate, jb)[0])


def test_float64_normalizer_is_kept_and_the_input_is_float32():
    """PETS' normalize_double_precision: float64 statistics on the port's side
    (JAX without x64 keeps float32), the model input cast to float32 after
    normalizing, and a float64 normalizer carried across by convert_state."""
    model = GaussianMLP(OBS + ACT, OBS + 1, 2, E, HID, device="cpu")
    tw = TransitionRewardModel(model, normalize=True, normalize_double_precision=True)
    state = tw.init(torch.Generator().manual_seed(0))
    assert state["normalizer"].mean.dtype == torch.float64
    arrays = _batch((50,))
    arrays = tuple(a.astype(np.float64) if a.dtype == np.float32 else a for a in arrays)
    batch = TransitionBatch(*arrays)
    for update in (tw.update_normalizer, tw.update_normalizer_host):
        new = update(state, batch)
        stats = new["normalizer"]
        assert stats.mean.dtype == torch.float64 and new["params"] is state["params"]
        data = np.concatenate([arrays[0], arrays[1]], axis=-1)
        np.testing.assert_allclose(stats.mean.numpy(), data.mean(0, keepdims=True), rtol=1e-12)
        np.testing.assert_allclose(stats.std.numpy(), data.std(0, keepdims=True, ddof=1), rtol=1e-12)
        model_in, _ = tw.process_batch(new, batch)
        assert model_in.dtype == torch.float32
        _close(model_in, (data - data.mean(0)) / data.std(0, ddof=1), 1e-5)
    carried = convert.convert_state(
        {"params": jax.tree_util.tree_map(np.asarray, JaxGaussianMLP(5, 4, 2, E, HID).init(
            jax.random.PRNGKey(0))),
         "normalizer": {"mean": stats.mean.numpy(), "std": stats.std.numpy()}}, "cpu")
    assert carried["normalizer"].mean.dtype == torch.float64 and carried["normalizer"].eps == 1e-12
    assert torch.equal(carried["normalizer"].std, stats.std)


def test_update_normalizer_matches_jax_with_obs_process_fn():
    jfn = lambda o: jnp.concatenate([o[..., :1], jnp.sin(o[..., 1:])], axis=-1)
    tfn = lambda o: torch.cat([o[..., :1], torch.sin(o[..., 1:])], dim=-1)
    jw, tw = _pair()
    jw.obs_process_fn, tw.obs_process_fn = jfn, tfn
    jstate, tstate = _states(jw)
    jb, tb = _both(_batch((40,)))
    for name in ("update_normalizer", "update_normalizer_host"):
        jn = getattr(jw, name)(jstate, jb)["normalizer"]
        tn = getattr(tw, name)(tstate, tb)["normalizer"]
        _close(tn.mean, jn.mean)
        _close(tn.std, jn.std)


# --------------------------------------------------------------------------- #
# gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_grad(deterministic, compute_dtype):
    jw, tw = _pair(deterministic=deterministic, compute_dtype=compute_dtype)
    jstate, tstate = _states(jw)
    jb, tb = _both(_batch((E, 16)))
    jt = JaxModelTrainer(jw)
    diff, static = jt._split_params(jstate["params"])
    jgrads = jax.grad(lambda d: jt._loss_fn(d, static, jstate["normalizer"], jb, None)[0])(diff)

    work = torch_trainer._Work(ModelTrainer(tw), tstate)
    loss, _ = tw.loss(work.state(), tb)
    loss.backward()
    assert len(work.paths) == 6  # two layers and the head: a weight and a bias each
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    for path, leaf in zip(work.paths, work.leaves):
        want = jgrads
        for key in path:
            want = want[key]
        want = np.asarray(want)
        assert leaf.grad is not None and np.abs(want).max() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())
    # frozen leaves (logvar bounds, elite indices) take no gradient and the
    # state handed in is untouched
    trainable = {p[0] for p in work.paths}
    assert trainable == {"layers", "head"}
    for path, leaf in tree_leaves_with_path(tstate["params"]):
        assert not leaf.requires_grad and leaf.grad is None


def test_learned_logvar_bounds_are_trainable():
    jw, tw = _pair(learn_logvar_bounds=True)
    assert tw.model.frozen_param_keys == () == jw.model.frozen_param_keys
    jstate, tstate = _states(jw)
    jb, tb = _both(_batch((E, 16)))
    jt = JaxModelTrainer(jw)
    diff, static = jt._split_params(jstate["params"])
    jgrads = jax.grad(lambda d: jt._loss_fn(d, static, jstate["normalizer"], jb, None)[0])(diff)
    work = torch_trainer._Work(ModelTrainer(tw), tstate)
    tw.loss(work.state(), tb)[0].backward()
    grads = dict(zip(work.paths, work.leaves))
    for key in ("min_logvar", "max_logvar"):
        want = np.asarray(jgrads[key])
        np.testing.assert_allclose(grads[(key,)].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    _, frozen = _pair()
    assert frozen.model.frozen_param_keys == ("min_logvar", "max_logvar") == frozen.frozen_param_keys


# --------------------------------------------------------------------------- #
# the host-iterator trainer
# --------------------------------------------------------------------------- #
def _flat_params(params):
    """{path: numpy leaf} of a params tree of either package."""
    if isinstance(params["head"]["w"], torch.Tensor):
        host = tree_map(lambda t: t.detach().numpy(), params)
    else:
        host = jax.tree_util.tree_map(np.asarray, params)
    return {"/".join(map(str, p)): leaf for p, leaf in tree_leaves_with_path(host)}


@pytest.mark.parametrize("deterministic", [False, True])
def test_three_epochs_match_the_jax_trainer(deterministic):
    """One pre-stacked dataset (no host randomness): 5 batches, padded to 8 on
    both sides, with Adam's coupled weight decay on every trainable leaf."""
    jw, tw = _pair(deterministic=deterministic)
    jstate, tstate = _states(jw)
    jtrain, ttrain = _both(_batch((5, E, 32), seed=3))
    jval, tval = _both(_batch((40,), seed=4))
    kw = dict(optim_lr=1e-3, weight_decay=1e-2)
    jnew, jlosses, jvals = JaxModelTrainer(jw, **kw).train(
        jstate, jtrain, dataset_val=jval, num_epochs=3, patience=10)
    tnew, tlosses, tvals = ModelTrainer(tw, **kw).train(
        tstate, ttrain, dataset_val=tval, num_epochs=3, patience=10)
    assert len(tlosses) == 3 == len(tvals)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(tvals, jvals, rtol=1e-3)
    want, got = _flat_params(jnew["params"]), _flat_params(tnew["params"])
    assert want.keys() == got.keys()
    for key in want:
        if key == "elite":
            assert sorted(want[key].tolist()) == sorted(got[key].tolist()) and len(got[key]) == 2
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-3)
    # the biases were decayed too: a bias-free decay would leave them further out
    assert "opt_state" in tnew and len(tnew["opt_state"]["param_groups"]) == 1
    assert tnew["opt_state"]["param_groups"][0]["weight_decay"] == 1e-2


def _learnable(n=256, seed=0):
    arrays = _batch((n,), seed=seed)
    return TransitionBatch(*arrays)


def test_patience_stops_and_best_weights_are_returned():
    _, tw = _pair()
    _, tstate = _states(_pair()[0])
    data = _learnable()
    train = TransitionBatch(*(np.broadcast_to(a[None, None], (1, E) + a.shape).copy()
                              for a in data.astuple()))
    trainer = ModelTrainer(tw, optim_lr=1e-3, pad_epoch_to_multiple=0)
    seen = []
    # an improvement no epoch can reach: every epoch counts against the patience
    new, losses, vals = trainer.train(tstate, train, dataset_val=data, patience=2,
                                      improvement_threshold=10.0,
                                      epoch_callback=lambda e, l, s: seen.append((e, l, s)))
    assert len(losses) == 2 and [e for e, _, _ in seen] == [0, 1]
    # nothing improved: the weights handed back are the ones handed in, not the last epoch's
    assert new["params"]["head"]["w"] is tstate["params"]["head"]["w"]
    assert trainer._train_iteration == 1

    # a loss that gets worse after the first epochs (a huge step size): the best epoch's
    # weights come back, and they score what that epoch scored
    trainer = ModelTrainer(tw, optim_lr=0.05, pad_epoch_to_multiple=0)
    scores = []

    def epoch_cb(epoch, loss, member_scores):
        scores.append(member_scores.copy())

    many = TransitionBatch(*(np.broadcast_to(a[None, None], (1, E) + a.shape).copy().repeat(6, 0)
                             for a in data.astuple()))
    new, losses, vals = trainer.train(tstate, many, dataset_val=data, num_epochs=12,
                                      patience=12, epoch_callback=epoch_cb)
    final = trainer.evaluate(new, data)
    best = trainer.evaluate(tstate, data)
    best_epoch = None
    for i, s in enumerate(scores):  # replay the trainer's rule
        if (((best - s) / np.maximum(np.abs(best), 1e-12)) > 0.01).any():
            best, best_epoch = np.minimum(best, s), i
    assert best_epoch is not None and best_epoch < len(scores) - 1, "the run never got worse"
    np.testing.assert_allclose(final, scores[best_epoch], rtol=1e-5)
    assert not np.allclose(final, scores[-1])
    assert sorted(new["params"]["elite"].tolist()) == sorted(np.argsort(final)[:2].tolist())


def test_opt_state_persists_and_inputs_are_never_mutated():
    _, tw = _pair()
    _, tstate = _states(_pair()[0])
    before = {k: v.copy() for k, v in _flat_params(tstate["params"]).items()}
    data = _learnable()
    train = TransitionBatch(*(np.broadcast_to(a[None, None], (2, E) + a.shape).copy()
                              for a in data.astuple()))
    trainer = ModelTrainer(tw, optim_lr=1e-3, pad_epoch_to_multiple=0)
    first, _, _ = trainer.train(tstate, train, dataset_val=data, num_epochs=2, patience=5)
    steps = [int(e["step"]) for e in first["opt_state"]["state"].values()]
    assert steps == [4] * 6
    for key, value in _flat_params(tstate["params"]).items():
        np.testing.assert_array_equal(value, before[key])  # the state handed in is untouched
    moments = first["opt_state"]["state"][0]["exp_avg"].clone()
    kept = {k: v.copy() for k, v in _flat_params(first["params"]).items()}
    second, _, _ = trainer.train(first, train, dataset_val=data, num_epochs=1, patience=5)
    assert [int(e["step"]) for e in second["opt_state"]["state"].values()] == [6] * 6
    # the first call's result is not written by the second: neither weights nor moments
    assert torch.equal(first["opt_state"]["state"][0]["exp_avg"], moments)
    for key, value in _flat_params(first["params"]).items():
        np.testing.assert_array_equal(value, kept[key])
    assert not any(l.requires_grad for _, l in tree_leaves_with_path(second["params"]))
    # without the carried moments the same epoch lands elsewhere
    carried, _, _ = trainer.train(first, train, num_epochs=1, evaluate=False)
    fresh, _, _ = trainer.train({k: v for k, v in first.items() if k != "opt_state"}, train,
                                num_epochs=1, evaluate=False)
    assert not torch.allclose(fresh["params"]["head"]["w"], carried["params"]["head"]["w"])


def test_divergence_raises_and_callbacks_fire():
    _, tw = _pair()
    _, tstate = _states(_pair()[0])
    data = _learnable(64)
    train = TransitionBatch(*(np.broadcast_to(a[None, None], (3, E) + a.shape).copy()
                              for a in data.astuple()))
    calls = {"batch": [], "train": []}
    trainer = ModelTrainer(tw, pad_epoch_to_multiple=0)
    trainer.train(tstate, train, dataset_val=data, num_epochs=2,
                  batch_callback=lambda e, l, m, kind: calls["batch"].append((e, m["grad_norm"], kind)),
                  callback=lambda *a: calls["train"].append(a))
    assert len(calls["batch"]) == 6 and all(n > 0 and k == "train" for _, n, k in calls["batch"])
    assert len(calls["train"]) == 2 and calls["train"][0][0] is tw
    bad = TransitionBatch(*train.astuple())
    bad.next_obs = bad.next_obs.copy()
    bad.next_obs[0, 0, 0, 0] = np.nan
    with pytest.raises(DivergenceError, match="non-finite"):
        trainer.train(tstate, bad, dataset_val=data, num_epochs=1)
    # a trainer on the one-process mesh trains as the plain one
    from mbrl_tpu_torch.parallel import make_parallel_context

    pctx = make_parallel_context({"parallel": {"enable": True}})
    plain = ModelTrainer(tw, pad_epoch_to_multiple=0).train(tstate, train, dataset_val=data,
                                                             num_epochs=1)
    meshed = ModelTrainer(tw, pad_epoch_to_multiple=0, parallel_ctx=pctx).train(
        tstate, train, dataset_val=data, num_epochs=1)
    assert plain[1] == meshed[1] and plain[2] == meshed[2]
    assert torch.equal(plain[0]["params"]["head"]["w"], meshed[0]["params"]["head"]["w"])
    # evaluate=False: no validation, the last weights come back
    new, losses, vals = trainer.train(tstate, train, num_epochs=1, evaluate=False)
    assert vals == [] and len(losses) == 1
    assert not torch.equal(new["params"]["head"]["w"], tstate["params"]["head"]["w"])


# --------------------------------------------------------------------------- #
# train_device
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 200, 256, 257, 1000, 4096, 5000, 10_000, 123_457])
def test_bucket_rows_matches_the_reference(n):
    assert torch_trainer._bucket_rows(n) == jax_trainer._bucket_rows(n)


@pytest.mark.parametrize("n,batch,ratio", [
    (200, 256, 0.0), (200, 32, 0.2), (700, 256, 0.0), (1000, 32, 0.05), (4097, 32, 0.05),
    (10_000, 32, 0.05), (5000, 256, 0.2), (50, 128, 0.5),
])
def test_device_epoch_sizes_match_the_reference(n, batch, ratio):
    """val_rows and num_batches as mbrl_tpu's train_device computes them
    (models/trainer.py, "Static program sizes"), for a dataset grown to n rows."""
    ds = DeviceTransitionDataset(OBS, ACT, device="cpu")
    capacity = ds._bucket(n)
    from mbrl_tpu.util.device_buffer import DeviceTransitionDataset as JaxDataset

    assert capacity == JaxDataset(OBS, ACT)._bucket(n)
    rows_bucket = min(jax_trainer._bucket_rows(min(n, capacity)), capacity)
    val_rows = max(int(np.ceil(rows_bucket * ratio)), 1)
    num_batches = max((rows_bucket - val_rows) // batch, 1)
    assert torch_trainer._device_sizes(n, capacity, batch, ratio) == (val_rows, num_batches)


def _make_buffer(n, capacity=512, seed=0):
    rng = np.random.default_rng(seed)
    rb = ReplayBuffer(capacity, (OBS,), (ACT,), rng=rng)
    for _ in range(n):
        obs = rng.normal(size=OBS).astype(np.float32)
        act = rng.normal(size=ACT).astype(np.float32)
        rb.add(obs, act, obs + 0.1 * act.sum(), float(obs[0]), False, False)  # linear dynamics
    return rb


def _device_setup(n=300, **kw):
    _, tw = _pair(**kw)
    state = tw.init(torch.Generator().manual_seed(0))
    rb = _make_buffer(n)
    state = tw.update_normalizer_host(state, rb.get_all())
    ds = DeviceTransitionDataset(OBS, ACT, min_capacity=64, device="cpu")
    ds.sync_from(rb)
    return tw, state, rb, ds


def test_train_device_learns_sets_elites_and_is_reproducible():
    tw, state, rb, ds = _device_setup()
    trainer = ModelTrainer(tw, optim_lr=3e-3)
    kw = dict(batch_size=32, val_ratio=0.2, num_epochs=15, patience=15)
    before = trainer.evaluate(state, rb.get_all()).mean()
    new, losses, vals = trainer.train_device(state, ds, generator=torch.Generator().manual_seed(7),
                                             **kw)
    assert len(losses) == 15 == len(vals) and np.isfinite(losses).all()
    assert vals[-1] < 0.2 * vals[0] and losses[-1] < losses[0]
    assert trainer.evaluate(new, rb.get_all()).mean() < 0.2 * before
    assert new["params"]["elite"].shape == (2,) and new["params"]["elite"].dtype == torch.int64
    assert "opt_state" in new and not new["params"]["head"]["w"].requires_grad
    again, losses2, vals2 = ModelTrainer(tw, optim_lr=3e-3).train_device(
        state, ds, generator=torch.Generator().manual_seed(7), **kw)
    assert losses2 == losses and vals2 == vals
    assert torch.equal(again["params"]["head"]["w"], new["params"]["head"]["w"])
    other, losses3, _ = ModelTrainer(tw, optim_lr=3e-3).train_device(
        state, ds, generator=torch.Generator().manual_seed(8), **kw)
    assert losses3 != losses


def test_train_device_patience_and_empty_validation():
    tw, state, rb, ds = _device_setup()
    trainer = ModelTrainer(tw, optim_lr=1e-3)
    new, losses, vals = trainer.train_device(state, ds, batch_size=32, val_ratio=0.2,
                                             patience=2, improvement_threshold=10.0, max_epochs=9)
    assert len(losses) == 2
    assert new["params"]["head"]["w"] is state["params"]["head"]["w"]  # nothing improved
    # val_ratio 0 (the cartpole setting): scored on training rows, still finite and learning
    new, losses, vals = trainer.train_device(state, ds, batch_size=32, val_ratio=0.0,
                                             num_epochs=6, patience=6)
    assert len(vals) == 6 and np.isfinite(vals).all() and vals[-1] < vals[0]
    bad = ds.data.next_obs.clone()
    ds.data.next_obs[:] = float("nan")
    with pytest.raises(DivergenceError):
        trainer.train_device(state, ds, batch_size=32, val_ratio=0.2, num_epochs=1)
    ds.data.next_obs[:] = bad


def test_train_device_tracks_the_host_path():
    """Both routes fit the same buffer to a comparable validation score (as
    mbrl_tpu's tests/test_device_training.py::TestDeviceTrainer has it)."""
    from mbrl_tpu_torch.util.common import get_basic_buffer_iterators

    tw, state, rb, ds = _device_setup(n=400)
    kw = dict(num_epochs=20, patience=20)
    dev_state, _, _ = ModelTrainer(tw, optim_lr=3e-3).train_device(
        state, ds, batch_size=32, val_ratio=0.2, **kw)
    train_it, val_it = get_basic_buffer_iterators(rb, 32, 0.2, ensemble_size=E)
    host_state, _, _ = ModelTrainer(tw, optim_lr=3e-3).train(state, train_it, dataset_val=val_it, **kw)
    trainer = ModelTrainer(tw)
    init = trainer.evaluate(state, rb.get_all()).mean()
    dev = trainer.evaluate(dev_state, rb.get_all()).mean()
    host = trainer.evaluate(host_state, rb.get_all()).mean()
    assert dev < 0.2 * init and host < 0.2 * init
    assert 0.2 < dev / host < 5.0, (dev, host)


# --------------------------------------------------------------------------- #
# training and the planner's packed weights
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("route", ["device", "host"])
def test_one_fresh_pack_per_retraining_and_never_stale_weights(route):
    tw, state, rb, ds = _device_setup(propagation_method="random_model")
    model = tw.model
    env = ModelEnv(tw, termination_fns.no_termination)
    seqs = torch.rand((6, 4, ACT), generator=torch.Generator().manual_seed(0)) * 2 - 1
    obs0 = torch.zeros(OBS)

    def plan(s, seed=3):
        with torch.no_grad():
            return env.evaluate_action_sequences(s, seqs, obs0, torch.Generator().manual_seed(seed), 2)

    before = plan(state)
    plan(state)
    assert model.packs == 1  # the plans between two retrainings share one pack
    trainer = ModelTrainer(tw, optim_lr=3e-3)
    for round_ in range(2):
        if route == "device":
            state, _, _ = trainer.train_device(state, ds, batch_size=32, val_ratio=0.2,
                                               num_epochs=2, patience=2)
        else:
            from mbrl_tpu_torch.util.common import get_basic_buffer_iterators

            train_it, val_it = get_basic_buffer_iterators(rb, 32, 0.2, ensemble_size=E)
            state, _, _ = trainer.train(state, train_it, dataset_val=val_it, num_epochs=2)
        packs = model.packs
        after = plan(state)
        assert model.packs == packs + 1  # exactly one fresh pack at the next plan
        plan(state), plan(state, seed=4)
        assert model.packs == packs + 1
        # and the plan used the new weights: a fresh model given them agrees
        _, other = _pair(propagation_method="random_model")
        fresh = ModelEnv(other, termination_fns.no_termination).evaluate_action_sequences(
            state, seqs, obs0, torch.Generator().manual_seed(3), 2)
        torch.testing.assert_close(after, fresh)
        assert not torch.allclose(after, before)
        before = after
