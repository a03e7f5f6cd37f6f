"""``BasicEnsemble`` of the port against mbrl_tpu's on the CPU: forward (all
members and elites), the deterministic propagation modes, loss, eval_score and
gradient on converted weights to 1e-5; the three mock-member propagation cases
of tests/test_models.py; ``basic_ensemble.yaml`` at its published width;
``model.pkl`` across the packages both ways; both trainer routes; and
``pets.train`` with the ensemble on the mock double integrator."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mbrl_tpu_torch.algorithms.pets as pets
from mbrl_tpu.config import create_one_dim_tr_model as jax_create_model
from mbrl_tpu.config import load_config as jax_load_config
from mbrl_tpu.config import to_dict as jax_to_dict
from mbrl_tpu.models import BasicEnsemble as JaxBasicEnsemble
from mbrl_tpu.models import GaussianMLP as JaxGaussianMLP
from mbrl_tpu.models import ModelTrainer as JaxTrainer
from mbrl_tpu.models import TransitionRewardModel as JaxTRM
from mbrl_tpu_torch import convert
from mbrl_tpu_torch.config import create_one_dim_tr_model, load_config, to_dict
from mbrl_tpu_torch.config.engine import resolve_interpolations
from mbrl_tpu_torch.models import (
    BasicEnsemble, GaussianMLP, ModelEnv, ModelTrainer, TransitionRewardModel,
)
from mbrl_tpu_torch.models.trainer import _Work
from mbrl_tpu_torch.ops.tree import tree_leaves_with_path
from mbrl_tpu_torch.types import TransitionBatch
from mbrl_tpu_torch.util.device_buffer import DeviceTransitionDataset
from test_torch_pets import (
    _INITIAL_EXPLORE, _TARGET_REWARD, _TRIAL_LEN, SEED, MockLineEnv, mock_reward_fn, mock_term_fn,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = REPO / "mbrl_tpu_torch" / "examples" / "conf"
JAX_CONF = REPO / "mbrl_tpu" / "examples" / "conf"
IN, OUT, E = 5, 4, 5


def _pair(deterministic=False, propagation=None, hid=16):
    """The same ensemble of one-member GaussianMLPs in both packages, the
    port's on converted weights."""
    jmodel = JaxBasicEnsemble(E, JaxGaussianMLP(IN, OUT, 2, 1, hid, deterministic=deterministic,
                                                activation="silu"),
                              propagation_method=propagation)
    tmodel = BasicEnsemble(E, GaussianMLP(IN, OUT, 2, 1, hid, deterministic=deterministic,
                                          activation="silu", device="cpu"),
                           propagation_method=propagation)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jmodel, tmodel, jparams, convert.convert_params(jparams, "cpu")


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _inputs(batch=12):
    rng = np.random.default_rng(0)
    return rng.standard_normal((batch, IN)).astype(np.float32), \
        rng.standard_normal((batch, OUT)).astype(np.float32)


def test_converted_params_keep_the_reference_layout():
    _, tmodel, jparams, tparams = _pair()
    got = {p: tuple(l.shape) for p, l in tree_leaves_with_path(tparams)}
    want = {tuple(k.key if hasattr(k, "key") else k.idx for k in p): tuple(l.shape)
            for p, l in jax.tree_util.tree_leaves_with_path(jparams)}
    assert got == want
    assert got[("members", "layers", 0, "w")] == (E, 1, IN, 16)  # the singleton member axis
    assert tparams["elite"].dtype == torch.int64
    init = tmodel.init(torch.Generator().manual_seed(0))
    assert {p: tuple(l.shape) for p, l in tree_leaves_with_path(init)} == got


@pytest.mark.parametrize("route", ["member_stack", "vmap"])
@pytest.mark.parametrize("deterministic", [False, True], ids=["gaussian", "deterministic"])
@pytest.mark.parametrize("use_only_elite", [False, True], ids=["all", "elites"])
def test_forward_matches_jax(deterministic, use_only_elite, route):
    """Both routes of the member forward: one GaussianMLP over the stacked
    members (what basic_ensemble.yaml's members take) and vmap (any member)."""
    jmodel, tmodel, jparams, tparams = _pair(deterministic)
    assert tmodel._stacks_gaussian_mlp
    tmodel._stacks_gaussian_mlp = route == "member_stack"
    jparams = jmodel.set_elite(jparams, [0, 2, 4])
    tparams = tmodel.set_elite(tparams, [0, 2, 4])
    x, _ = _inputs()
    jm, jlv = jmodel.forward(jparams, jnp.asarray(x), use_only_elite=use_only_elite)
    tm, tlv = tmodel.forward(tparams, torch.as_tensor(x), use_only_elite=use_only_elite)
    assert tm.shape == (3 if use_only_elite else E, 12, OUT)
    _close(tm, jm)
    assert (tlv is None) == (jlv is None) == deterministic
    if not deterministic:
        _close(tlv, jlv)
    # a per-member input (E', B, in)
    xs = np.random.default_rng(1).standard_normal((E, 7, IN)).astype(np.float32)
    _close(tmodel.forward(tparams, torch.as_tensor(xs))[0], jmodel.forward(jparams, jnp.asarray(xs))[0])


@pytest.mark.parametrize("method", ["fixed_model", "expectation"])
def test_deterministic_propagation_matches_jax(method):
    jmodel, tmodel, jparams, tparams = _pair(propagation=method)
    jparams = jmodel.set_elite(jparams, [1, 3, 4])
    tparams = tmodel.set_elite(tparams, [1, 3, 4])
    x, _ = _inputs(10)
    idx = np.random.default_rng(2).integers(0, E, 10)
    jm, jlv = jmodel.forward_propagated(jparams, jnp.asarray(x), propagation_indices=jnp.asarray(idx))
    tm, tlv = tmodel.forward_propagated(tparams, torch.as_tensor(x),
                                        propagation_indices=torch.as_tensor(idx))
    assert tm.shape == (10, OUT)
    _close(tm, jm)
    _close(tlv, jlv)


def test_random_model_draws_an_elite_per_row():
    _, tmodel, _, tparams = _pair(propagation="random_model")
    tparams = tmodel.set_elite(tparams, [0, 4])
    x = torch.as_tensor(_inputs(400)[0])
    got, _ = tmodel.forward_propagated(tparams, x, generator=torch.Generator().manual_seed(0))
    mean, _ = tmodel.forward(tparams, x, use_only_elite=True)
    which = (got[None] == mean).all(dim=-1)  # (2, 400): the member each row came from
    assert bool((which.sum(0) == 1).all())
    assert 150 < int(which[0].sum()) < 250  # both elites, about half each
    with pytest.raises(ValueError, match="generator"):
        tmodel.forward_propagated(tparams, x)


@pytest.mark.parametrize("deterministic", [False, True], ids=["gaussian", "deterministic"])
def test_loss_eval_score_and_gradient_match_jax(deterministic):
    jmodel, tmodel, jparams, tparams = _pair(deterministic)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((E, 9, IN)).astype(np.float32)
    y = rng.standard_normal((E, 9, OUT)).astype(np.float32)

    def jloss(p):
        return jmodel.loss(p, jnp.asarray(x), jnp.asarray(y))[0]

    jval, jgrad = jax.value_and_grad(jloss, allow_int=True)(jax.tree_util.tree_map(jnp.asarray, jparams))
    leaves = {p: l.requires_grad_(True) for p, l in tree_leaves_with_path(tparams)
              if l.is_floating_point()}
    tval, _ = tmodel.loss(tparams, torch.as_tensor(x), torch.as_tensor(y))
    tval.backward()
    _close(tval, jval)
    jflat = {tuple(k.key if hasattr(k, "key") else k.idx for k in p): g
             for p, g in jax.tree_util.tree_leaves_with_path(jgrad)}
    for path, leaf in leaves.items():
        _close(leaf.grad, jflat[path])
    # a 2-D batch goes to every member
    x2, y2 = _inputs()
    with torch.no_grad():
        _close(tmodel.loss(tparams, torch.as_tensor(x2), torch.as_tensor(y2))[0],
               jmodel.loss(jparams, jnp.asarray(x2), jnp.asarray(y2))[0])
    tscore, _ = tmodel.eval_score(tparams, torch.as_tensor(x2), torch.as_tensor(y2))
    jscore, _ = jmodel.eval_score(jparams, jnp.asarray(x2), jnp.asarray(y2))
    assert tscore.shape == (E, 12, OUT)
    _close(tscore, jscore)


def test_trainer_trains_the_leaves_the_jax_trainer_trains():
    """BasicEnsemble has no frozen keys in either package: every float leaf,
    the members' logvar bounds too, is trained."""
    jmodel, tmodel, jparams, tparams = _pair()
    jwrapper = JaxTRM(jmodel, normalize=False)
    twrapper = TransitionRewardModel(tmodel, normalize=False)
    diff, _ = JaxTrainer(jwrapper)._split_params(jax.tree_util.tree_map(jnp.asarray, jparams))
    want = sorted(tuple(k.key if hasattr(k, "key") else k.idx for k in p)
                  for p, l in jax.tree_util.tree_leaves_with_path(diff) if l is not None)
    work = _Work(ModelTrainer(twrapper), {"params": tparams, "normalizer": None})
    assert sorted(work.paths) == want
    assert ("members", "min_logvar") in want


def _synthetic_batch(rows=256):
    rng = np.random.default_rng(5)
    obs = rng.standard_normal((rows, 2))
    act = rng.uniform(-1, 1, (rows, 1))
    next_obs = obs + 0.1 * np.concatenate([act, obs[:, :1]], 1)
    return TransitionBatch(obs, act, next_obs, np.zeros(rows), np.zeros(rows, bool), np.zeros(rows, bool))


@pytest.mark.parametrize("route", ["train", "train_device"])
def test_both_trainer_routes_take_the_ensemble(route):
    member = GaussianMLP(3, 2, 2, 1, 32, activation="silu", device="cpu")
    wrapper = TransitionRewardModel(BasicEnsemble(E, member, "fixed_model"), normalize=False,
                                    learned_rewards=False, num_elites=3)
    state = wrapper.init(torch.Generator().manual_seed(0))
    batch = _synthetic_batch()
    trainer = ModelTrainer(wrapper, optim_lr=1e-2)
    score0 = trainer.evaluate(state, batch)
    if route == "train":
        new, losses, _ = trainer.train(state, batch[np.arange(256).reshape(8, 32)], batch,
                                       num_epochs=5)
    else:
        dataset = DeviceTransitionDataset(2, 1, device="cpu")
        dataset.append(batch)
        new, losses, _ = trainer.train_device(state, dataset, batch_size=32, val_ratio=0.1,
                                              num_epochs=5)
    assert np.isfinite(losses).all() and len(losses) == 5
    assert new["params"]["elite"].shape == (3,)
    assert trainer.evaluate(new, batch).mean() < score0.mean()
    # the state handed in is never written
    assert state["params"]["elite"].shape == (E,)


# --------------------------------------------------------------------------- #
# tests/test_models.py's mock members, whose outputs name the member
# --------------------------------------------------------------------------- #
class MockProbModel:
    in_size = 2
    out_size = 2
    deterministic = True
    device = torch.device("cpu")

    def init(self, generator):
        return {"value": torch.zeros(())}

    def forward(self, params, x):
        return params["value"] * torch.ones((x.shape[0], self.out_size)), None

    def loss(self, params, model_in, target):
        mean, _ = self.forward(params, model_in)
        return torch.square(mean - target).sum(), {}


MEMBER_INCS = [10.0, 11.0, 12.0]


def _mock_model_env(propagation_method):
    ens = BasicEnsemble(3, MockProbModel(), propagation_method=propagation_method)
    wrapper = TransitionRewardModel(ens, target_is_delta=True, normalize=False)
    state = wrapper.init(torch.Generator().manual_seed(0))
    state["params"]["members"]["value"] = torch.tensor(MEMBER_INCS)
    return ModelEnv(wrapper, lambda a, o: torch.zeros((o.shape[0], 1), dtype=torch.bool)), state


def test_model_env_expectation_propagation():
    batch_size = 7
    env, state = _mock_model_env("expectation")
    g = torch.Generator().manual_seed(0)
    ms = env.reset(state, np.zeros((batch_size, 1), np.float32), g)
    action = np.zeros((batch_size, 1), np.float32)
    prev_sum = 0.0
    for _ in range(10):
        next_obs, reward, done, ms = env.step(state, action, ms, g, sample=False)
        assert next_obs.shape == (batch_size, 1)
        cur_sum = float(next_obs.sum())
        assert (cur_sum - prev_sum) == pytest.approx(batch_size * np.mean(MEMBER_INCS))
        assert float(reward[0, 0]) == pytest.approx(np.mean(MEMBER_INCS))
        prev_sum = cur_sum


def test_model_env_random_model_propagation():
    batch_size = 100
    env, state = _mock_model_env("random_model")
    g = torch.Generator().manual_seed(0)
    obs = np.zeros((batch_size, 1), np.float32)
    ms = env.reset(state, obs, g)
    action = np.zeros((batch_size, 1), np.float32)
    history = ["" for _ in range(batch_size)]
    for _ in range(50):
        next_obs, *_, ms = env.step(state, action, ms, g)
        diff = next_obs.numpy() - obs
        seen = set()
        for j, v in enumerate(diff[:, 0]):
            v = int(round(float(v)))
            assert v in MEMBER_INCS
            seen.add(v)
            history[j] += str(int(v - 10))
        assert len(seen) == 3  # every member is used somewhere in the batch
        obs = next_obs.numpy()
    # the member changes over time for (virtually) every particle
    assert len(set(history)) == batch_size


def test_model_env_fixed_model_propagation():
    batch_size = 99
    env, state = _mock_model_env("fixed_model")
    g = torch.Generator().manual_seed(0)
    obs = np.zeros((batch_size, 1), np.float32)
    ms = env.reset(state, obs, g)
    action = np.zeros((batch_size, 1), np.float32)
    history = ["" for _ in range(batch_size)]
    seen_all = set()
    for _ in range(50):
        next_obs, *_, ms = env.step(state, action, ms, g)
        diff = next_obs.numpy() - obs
        for j, v in enumerate(diff[:, 0]):
            v = int(round(float(v)))
            assert v in MEMBER_INCS
            seen_all.add(v)
            history[j] += str(int(v - 10))
        obs = next_obs.numpy()
    assert len(seen_all) == 3
    # TSinf: each particle keeps one member
    for h in history:
        assert len(set(h)) == 1


# --------------------------------------------------------------------------- #
# The YAML tree, model.pkl, pets.train
# --------------------------------------------------------------------------- #
def _repointed(tree):
    if isinstance(tree, dict):
        return {k: _repointed(v) for k, v in tree.items()}
    if isinstance(tree, str) and tree.startswith("mbrl_tpu."):
        return "mbrl_tpu_torch." + tree[len("mbrl_tpu."):]
    return tree


def test_basic_ensemble_yaml_at_its_published_width():
    args = ["algorithm=pets", "dynamics_model=basic_ensemble"]
    cfg = load_config(CONF, "main", overrides=args)
    jcfg = jax_load_config(JAX_CONF, "main", overrides=args)
    assert to_dict(cfg) == _repointed(jax_to_dict(jcfg))
    wrapper = create_one_dim_tr_model(cfg, (4,), (1,), device="cpu")
    jwrapper = jax_create_model(jcfg, (4,), (1,))
    ens = wrapper.model
    assert type(ens) is BasicEnsemble and not hasattr(ens, "supports_fast_rollout")
    assert (ens.ensemble_size, ens.propagation_method) == (5, "fixed_model")
    member = ens.member
    assert type(member) is GaussianMLP and member.device.type == "cpu"
    assert (member.in_size, member.out_size, member.num_layers, member.hid_size,
            member.ensemble_size, member.activation_name) == (5, 4, 4, 200, 1, "silu")
    jmember = jwrapper.model.member
    assert (jmember.in_size, jmember.out_size, jmember.hid_size) == (5, 4, 200)
    assert wrapper.num_elites == jwrapper.num_elites == 5 and len(wrapper) == 5
    state = wrapper.init(torch.Generator().manual_seed(0))
    assert state["params"]["members"]["layers"][1]["w"].shape == (5, 1, 200, 200)
    assert state["normalizer"].mean.dtype == torch.float64


def test_model_pkl_crosses_the_packages_both_ways(tmp_path):
    jmodel, tmodel, jparams, _ = _pair()
    jwrapper = JaxTRM(jmodel, normalize=True)
    twrapper = TransitionRewardModel(tmodel, normalize=True)
    jstate = jwrapper.init(jax.random.PRNGKey(7))
    jstate = {**jstate, "params": jmodel.set_elite(jax.tree_util.tree_map(jnp.asarray, jparams), [1, 2])}
    x, _ = _inputs()
    # JAX writes, the port reads
    (tmp_path / "a").mkdir()
    jwrapper.save(jstate, tmp_path / "a")
    tstate = twrapper.load(twrapper.init(torch.Generator().manual_seed(0)), tmp_path / "a")
    assert tstate["params"]["elite"].tolist() == [1, 2]
    _close(tmodel.forward(tstate["params"], torch.as_tensor(x), use_only_elite=True)[0],
           jmodel.forward(jstate["params"], jnp.asarray(x), use_only_elite=True)[0])
    # the port writes, JAX reads
    tstate = {**tstate, "params": tmodel.set_elite(tstate["params"], [4, 0, 3])}
    (tmp_path / "b").mkdir()
    twrapper.save(tstate, tmp_path / "b")
    back = jwrapper.load(jwrapper.init(jax.random.PRNGKey(0)), tmp_path / "b")
    assert np.asarray(back["params"]["elite"]).tolist() == [4, 0, 3]
    _close(tmodel.forward(tstate["params"], torch.as_tensor(x))[0],
           jmodel.forward(back["params"], jnp.asarray(x))[0])


def _pets_cfg(budget_trials=1):
    cfg = load_config(CONF, "main", overrides=["algorithm=pets", "overrides=pets_cartpole",
                                               "dynamics_model=basic_ensemble"])
    cfg.seed = SEED
    cfg.overrides["num_steps"] = _TRIAL_LEN * budget_trials + _INITIAL_EXPLORE
    cfg.overrides["trial_length"] = _TRIAL_LEN
    cfg.overrides["model_batch_size"] = 128
    cfg.overrides["freq_train_model"] = 30
    cfg.algorithm["initial_exploration_steps"] = _INITIAL_EXPLORE
    cfg.algorithm["num_particles"] = 5
    member = cfg.dynamics_model.member_cfg
    member["hid_size"] = 64
    member["num_layers"] = 2
    # tests/test_algorithms.py's basic-ensemble case: deterministic members,
    # every member an elite, a larger planning and training budget
    cfg.dynamics_model["ensemble_size"] = 5
    member["deterministic"] = True
    cfg.overrides["num_elites"] = 5
    cfg.overrides["planning_horizon"] = 15
    cfg.overrides["cem_population_size"] = 350
    cfg.overrides["num_epochs_train_model"] = 25
    cfg.overrides["patience"] = 10
    resolve_interpolations(cfg)
    return cfg


def test_short_pets_run_with_the_basic_ensemble(tmp_path):
    cfg = _pets_cfg()
    agent = cfg.algorithm.agent
    agent["planning_horizon"] = 5
    agent.optimizer["population_size"] = 40
    agent.optimizer["num_iterations"] = 2
    cfg.overrides["num_steps"] = 40  # planned steps, after the exploration
    cfg.overrides["num_epochs_train_model"] = 3
    best = pets.train(MockLineEnv(), mock_term_fn, mock_reward_fn, cfg, silent=True,
                      work_dir=str(tmp_path), device="cpu")
    assert np.isfinite(best)
    wrapper = create_one_dim_tr_model(cfg, (2,), (1,), device="cpu")
    state = wrapper.load(wrapper.init(torch.Generator().manual_seed(0)), tmp_path)
    assert state["params"]["members"]["head"]["w"].shape == (5, 1, 64, 2)
    assert sorted(state["params"]["elite"].tolist()) == [0, 1, 2, 3, 4]


@pytest.mark.slow
def test_pets_basic_ensemble_mock_line_env_converges(tmp_path):
    """tests/test_algorithms.py's basic-ensemble case, at its budget."""
    cfg = _pets_cfg(budget_trials=5)
    best = pets.train(MockLineEnv(), mock_term_fn, mock_reward_fn, cfg, silent=True,
                      work_dir=str(tmp_path), device="cpu")
    assert best > _TARGET_REWARD, best
