"""The port's config engine, factories and YAML tree against mbrl_tpu's: the
PETS part of the tree resolves to the same values apart from the re-pointed
targets, and chip_smoke.py's config E is that tree with ``num_steps`` cut."""
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from mbrl_tpu.config import load_config as jax_load_config
from mbrl_tpu.config import to_dict as jax_to_dict
from mbrl_tpu_torch.config import (
    Config, complete_agent_cfg, create_agent, create_one_dim_tr_model, instantiate, load_config,
    parse_overrides, to_dict,
)
from mbrl_tpu_torch.config.engine import resolve_interpolations
from mbrl_tpu_torch.envs.cartpole_continuous import CartPoleEnv

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = REPO / "mbrl_tpu_torch" / "examples" / "conf"
JAX_CONF = REPO / "mbrl_tpu" / "examples" / "conf"

PETS_OVERRIDES = sorted(p.stem for p in (JAX_CONF / "overrides").glob("pets_*.yaml"))
MBPO_OVERRIDES = sorted(p.stem for p in (JAX_CONF / "overrides").glob("*mbpo_*.yaml"))
PLANET_OVERRIDES = sorted(p.stem for p in (JAX_CONF / "overrides").glob("planet_*.yaml"))
MODELS = ["gaussian_mlp", "gaussian_mlp_ensemble", "gaussian_mlp_ensemble_fast",
          "gaussian_mlp_ensemble_pallas"]


def _repointed(tree):
    """The JAX tree with every dotted path into mbrl_tpu re-pointed at the port."""
    if isinstance(tree, dict):
        return {k: _repointed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_repointed(v) for v in tree]
    if isinstance(tree, str) and tree.startswith("mbrl_tpu."):
        return "mbrl_tpu_torch." + tree[len("mbrl_tpu."):]
    return tree


def _optimizer_for(overrides):
    return {"pets_icem_cartpole": "icem", "pets_mppi_halfcheetah": "mppi"}.get(overrides, "cem")


@pytest.mark.parametrize("overrides", PETS_OVERRIDES)
def test_every_pets_override_resolves_as_in_the_jax_tree(overrides):
    args = ["algorithm=pets", f"overrides={overrides}",
            f"action_optimizer={_optimizer_for(overrides)}"]
    got = to_dict(load_config(CONF, "main", overrides=args))
    want = _repointed(jax_to_dict(jax_load_config(JAX_CONF, "main", overrides=args)))
    assert got == want
    assert got["algorithm"]["agent"]["optimizer"] == got["action_optimizer"]
    assert "${" not in str(got)


@pytest.mark.parametrize("overrides", MBPO_OVERRIDES)
def test_every_mbpo_override_resolves_as_in_the_jax_tree(overrides):
    args = ["algorithm=mbpo", f"overrides={overrides}"]
    got = to_dict(load_config(CONF, "main", overrides=args))
    want = _repointed(jax_to_dict(jax_load_config(JAX_CONF, "main", overrides=args)))
    assert got == want
    assert got["algorithm"]["name"] == "mbpo" and got["algorithm"]["freq_train_model"] == \
        got["overrides"]["freq_train_model"]


@pytest.mark.parametrize("overrides", PLANET_OVERRIDES)
def test_every_planet_override_resolves_as_in_the_jax_tree(overrides):
    args = ["algorithm=planet", "dynamics_model=planet", f"overrides={overrides}"]
    got = to_dict(load_config(CONF, "main", overrides=args))
    want = _repointed(jax_to_dict(jax_load_config(JAX_CONF, "main", overrides=args)))
    assert got == want
    assert got["overrides"]["env_cfg"]["_target_"] == "mbrl_tpu_torch.util.dmcontrol_wrapper.make"
    assert got["dynamics_model"]["_target_"] == "mbrl_tpu_torch.models.PlaNetModel"


def test_planet_yaml_files_differ_from_the_jax_ones_only_in_their_targets():
    files = ([pathlib.Path("algorithm/planet.yaml"), pathlib.Path("dynamics_model/planet.yaml")]
             + [pathlib.Path("overrides") / f"{n}.yaml" for n in PLANET_OVERRIDES])
    assert len(files) == 8
    for rel in files:
        assert (CONF / rel).read_text() == \
            (JAX_CONF / rel).read_text().replace("mbrl_tpu.", "mbrl_tpu_torch."), rel


def test_planet_dynamics_model_instantiates_at_its_published_width():
    cfg = load_config(CONF, "main", overrides=["algorithm=planet", "dynamics_model=planet",
                                               "overrides=planet_cheetah_run"])
    cfg.dynamics_model["action_size"] = 6
    model = instantiate(cfg.dynamics_model, device="cpu")
    assert type(model).__name__ == "PlaNetModel" and model.encoder.identity_head
    assert (model.belief_size, model.latent_state_size, model.free_nats) == (200, 30, 3)
    state = model.init(torch.Generator().manual_seed(0))
    assert state["params"]["belief_gru"]["w_ih"].shape == (200, 600)
    assert state["params"]["decoder"]["deconvs"][0]["w"].shape == (1024, 128, 5, 5)


def test_chip_smoke_config_pn_is_the_loaded_tree_with_its_cuts():
    sys.path.insert(0, str(REPO))
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(REPO))
    loaded = to_dict(load_config(CONF, "main", overrides=[
        "algorithm=planet", "dynamics_model=planet", "overrides=planet_cheetah_run"]))
    algo = loaded["algorithm"]
    assert {k: algo[k] for k in ("num_episodes", "dataset_size")} == chip_smoke.PN_PUBLISHED \
        == {"num_episodes": 1000, "dataset_size": 1_000_000}
    algo["num_episodes"] = chip_smoke.PN_EPISODES
    algo["dataset_size"] = chip_smoke.PN_DATASET_SIZE
    assert chip_smoke.CONFIG_PN == loaded
    # the cut buffer holds every row of the cut run; its episodes are one
    # test episode (no exploration noise) and one with noise
    trial = loaded["overrides"]["trial_length"]
    assert (algo["num_initial_trajectories"] + chip_smoke.PN_EPISODES) * trial \
        <= chip_smoke.PN_DATASET_SIZE
    assert chip_smoke.PN_EPISODES == 2 and algo["test_frequency"] > 1
    env = chip_smoke.PixelCheetah()
    obs, _ = env.reset()
    assert obs.shape == tuple(loaded["dynamics_model"]["obs_shape"]) and obs.dtype == np.uint8
    assert env.action_space.shape == (chip_smoke.ACT_PN,)
    nxt, reward, terminated, truncated, _ = env.step(np.ones(chip_smoke.ACT_PN, np.float32))
    assert not (nxt == obs).all() and np.isfinite(reward) and not (terminated or truncated)
    assert (obs % 2 ** (8 - loaded["overrides"]["env_cfg"]["bit_depth"]) == 0).all()


@pytest.mark.parametrize("model", MODELS)
def test_every_dynamics_model_file_resolves_and_instantiates(model):
    args = ["algorithm=pets", f"dynamics_model={model}"]
    cfg = load_config(CONF, "main", overrides=args)
    assert to_dict(cfg) == _repointed(jax_to_dict(jax_load_config(JAX_CONF, "main", overrides=args)))
    wrapper = create_one_dim_tr_model(cfg, (4,), (1,), device="cpu")
    net = wrapper.model
    assert (net.in_size, net.out_size, net.hid_size, net.num_layers) == (5, 4, 200, 4)
    assert net.ensemble_size == (1 if model == "gaussian_mlp" else 7)
    assert net.frozen_param_keys == ("min_logvar", "max_logvar")  # learn_logvar_bounds: false
    fast = model in ("gaussian_mlp_ensemble_fast", "gaussian_mlp_ensemble_pallas")
    assert net.compute_dtype == (torch.bfloat16 if fast else torch.float32)
    assert net.rollout_shuffle == ("rotate" if fast else "sort")
    assert wrapper.num_elites == 5 and wrapper.normalize_double_precision
    assert wrapper.init(torch.Generator().manual_seed(0))["normalizer"].mean.dtype == torch.float64


def test_every_target_and_obs_process_fn_in_the_port_tree_imports():
    import yaml

    from mbrl_tpu_torch.config.engine import _import_target

    seen = []
    for path in sorted(CONF.rglob("*.yaml")):
        text = path.read_text()
        assert "mbrl_tpu." not in text, path
        tree = yaml.safe_load(text) or {}
        for key in ("_target_", "obs_process_fn"):
            if key in tree:
                seen.append(tree[key])
        if "agent" in tree:
            seen.append(tree["agent"]["_target_"])
    assert len(seen) >= 10
    for target in seen:
        assert target.startswith("mbrl_tpu_torch.") and callable(_import_target(target)), target
    copied = {p.relative_to(CONF) for p in CONF.rglob("*.yaml")}
    assert {pathlib.Path("overrides") / f"{n}.yaml" for n in PETS_OVERRIDES + MBPO_OVERRIDES} <= copied
    assert pathlib.Path("algorithm/mbpo.yaml") in copied
    assert pathlib.Path("parallel/none.yaml") in copied


def test_chip_smoke_config_e_is_the_loaded_tree_with_num_steps_cut():
    sys.path.insert(0, str(REPO))
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(REPO))
    loaded = to_dict(load_config(CONF, "main", overrides=[
        "algorithm=pets", "overrides=pets_cartpole", "dynamics_model=gaussian_mlp_ensemble",
        "action_optimizer=cem"]))
    assert loaded["overrides"]["num_steps"] == 5000
    assert chip_smoke.CONFIG_E["overrides"]["num_steps"] == chip_smoke.E_PLANNED_STEPS >= 100
    loaded["overrides"]["num_steps"] = chip_smoke.E_PLANNED_STEPS
    assert chip_smoke.CONFIG_E == loaded
    # the planned steps cover at least two retrainings
    assert chip_smoke.E_PLANNED_STEPS >= 2 * loaded["algorithm"]["freq_train_model"]


def test_chip_smoke_config_m_is_the_loaded_tree_with_its_cuts():
    sys.path.insert(0, str(REPO))
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(REPO))
    loaded = to_dict(load_config(CONF, "main", overrides=[
        "algorithm=mbpo", "overrides=mbpo_cartpole", "dynamics_model=gaussian_mlp_ensemble"]))
    published = loaded["overrides"]["num_steps"]
    assert published == 5000 and "dataset_size" not in loaded["algorithm"]
    assert chip_smoke.M_PUBLISHED_STEPS == published  # what --published-m restores
    # the cuts: two epochs of the loop, the replay buffer kept at the published
    # run's size; and the run saves model, buffer and checkpoint at each retraining
    loaded["overrides"]["num_steps"] = chip_smoke.M_NUM_STEPS
    loaded["algorithm"]["dataset_size"] = published
    loaded["checkpoint_every"] = loaded["overrides"]["freq_train_model"]
    assert chip_smoke.CONFIG_M == loaded
    assert chip_smoke.M_NUM_STEPS == 2 * loaded["overrides"]["epoch_length"]


def test_config_engine_basics():
    cfg = Config({"a": {"b": 1, "c": "${x.y}"}, "x": {"y": 7}, "m": "???"})
    resolve_interpolations(cfg)
    assert cfg.a.c == 7 and cfg.a["b"] == 1 and cfg.get("nope", 3) == 3 and cfg.get("m") is None
    with pytest.raises(ValueError):
        cfg.m
    cfg.set_path("a.d.e", 5)
    assert cfg.get_path("a.d.e") == 5 and "a" in cfg and cfg.copy().a.b == 1
    groups, values = parse_overrides(["algorithm=pets", "overrides.model_lr=0.001", "x.flag=true"])
    assert groups == {"algorithm": "pets"} and values == [("overrides.model_lr", 1e-3), ("x.flag", True)]
    with pytest.raises(ValueError):
        parse_overrides(["novalue"])
    with pytest.raises(FileNotFoundError):
        load_config(CONF, "main", overrides=["overrides=no_such_override"])  # no such file
    cfg = load_config(CONF, "main", overrides=["overrides.model_lr=0.001", "seed=3"])
    assert cfg.overrides.model_lr == 1e-3 and cfg.seed == 3 and cfg.overrides.model_wd == 3e-5
    import pickle

    assert pickle.loads(pickle.dumps(cfg)).seed == 3
    with pytest.raises(ValueError, match="_target_"):
        instantiate({"x": 1})
    with pytest.raises(ValueError, match=r"\?\?\?"):
        instantiate({"_target_": "mbrl_tpu_torch.planning.CEMOptimizer", "lower_bound": "???"})


@pytest.mark.parametrize("optimizer", ["cem", "icem", "mppi"])
def test_agent_is_completed_and_instantiated_from_the_tree(optimizer):
    overrides = {"cem": "pets_cartpole", "icem": "pets_icem_cartpole", "mppi": "pets_cartpole"}[optimizer]
    cfg = load_config(CONF, "main", overrides=[f"overrides={overrides}",
                                               f"action_optimizer={optimizer}"])
    if optimizer == "mppi":
        for key, value in dict(mppi_num_iters=2, mppi_population_size=20, mppi_gamma=0.9,
                               mppi_sigma=1.0, mppi_beta=0.9).items():
            cfg.overrides[key] = value
        resolve_interpolations(cfg)
    env = CartPoleEnv()
    agent_cfg = complete_agent_cfg(env, cfg.algorithm.agent, device="cpu")
    horizon = cfg.overrides.planning_horizon
    assert agent_cfg.action_lb == [-1.0] and agent_cfg.action_ub == [1.0]
    assert np.asarray(agent_cfg.optimizer.lower_bound).shape == (horizon, 1)
    assert agent_cfg.optimizer.device == "cpu"
    agent = instantiate(agent_cfg, seed=1)
    inner = agent.optimizer.optimizer
    assert type(inner).__name__ == {"cem": "CEMOptimizer", "icem": "ICEMOptimizer",
                                    "mppi": "MPPIOptimizer"}[optimizer]
    assert inner.device.type == "cpu" and agent.optimizer.horizon == horizon
    if optimizer == "icem":  # sizes rounded to the ensemble's 7 members
        assert all(n % 7 == 0 for n in inner.decay_population_sizes)
    again = create_agent(env, load_config(CONF, "main").algorithm.agent, device="cpu")
    assert again.optimizer.optimizer.population_size == 350
