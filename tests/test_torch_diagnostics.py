"""The port's diagnostics (``mbrl_tpu_torch/diagnostics``), ``load_agent`` for
PETS and the packaging (``util/huggingface.py``) against mbrl_tpu's, on one run
directory that the JAX package wrote (tests/test_diagnostics.py's recipe:
``pets.train`` on the continuous cartpole at a small width, leaving
``config.yaml``, ``model.pkl`` and ``replay_buffer.npz``), on the CPU.

Tolerances: model forwards (members' means and log-variances) 1e-5 absolute
(float32 products of width 16 in two libraries, behind a float64
normalizer); the replay buffer, the config dicts, the real environment's
rollout along one plan, the packaged README and metadata (but for the lines
that name the library) are equal.
"""
import json
import pathlib
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from mbrl_tpu.config import load_config as jax_load_config
from mbrl_tpu.config import to_dict as jax_to_dict
from mbrl_tpu.config.engine import resolve_interpolations as jax_resolve
from mbrl_tpu.diagnostics import common as jax_common
from mbrl_tpu.util.env import create_handler as jax_create_handler
from mbrl_tpu_torch.diagnostics import DatasetEvaluator, FineTuner, Visualizer
from mbrl_tpu_torch.diagnostics import common
from mbrl_tpu_torch.diagnostics import training_browser
from mbrl_tpu_torch.diagnostics.control_env import TrueDynamicsController
from mbrl_tpu_torch.planning import TrajectoryOptimizerAgent, load_agent
from mbrl_tpu_torch.util import huggingface as hf

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_CONF = REPO / "mbrl_tpu" / "examples" / "conf"
FORWARD_ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the test workers share the
    CPU, and a pool of threads per worker over small products slows them all
    many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A minuscule PETS run of the JAX package (tests/test_diagnostics.py:13-45)."""
    import mbrl_tpu.algorithms.pets as jax_pets

    out = tmp_path_factory.mktemp("jax_pets_run")
    cfg = jax_load_config(JAX_CONF, "main", overrides=["overrides=pets_cartpole"])
    cfg.seed = 0
    cfg.overrides["num_steps"] = 40
    cfg.overrides["trial_length"] = 20
    cfg.overrides["freq_train_model"] = 20
    cfg.overrides["num_epochs_train_model"] = 2
    cfg.overrides["patience"] = 2
    cfg.overrides["cem_population_size"] = 40
    cfg.overrides["planning_horizon"] = 5
    cfg.overrides["model_batch_size"] = 32
    cfg.algorithm["initial_exploration_steps"] = 20
    cfg.algorithm["num_particles"] = 3
    cfg.dynamics_model["hid_size"] = 16
    cfg.dynamics_model["num_layers"] = 1
    jax_resolve(cfg)
    with open(out / "config.yaml", "w") as f:
        yaml.safe_dump(jax_to_dict(cfg), f)
    env, term_fn, reward_fn = jax_create_handler(cfg).make_env(cfg)
    jax_pets.train(env, term_fn, reward_fn, cfg, silent=True, work_dir=str(out))
    return out


@pytest.fixture
def run_dir(jax_run, tmp_path):
    """A private copy of the JAX run (diagnostics write into it)."""
    dst = tmp_path / "run"
    shutil.copytree(jax_run, dst)
    return dst


def _port_names(tree):
    if isinstance(tree, dict):
        return {k: _port_names(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_names(v) for v in tree]
    if isinstance(tree, str) and tree.startswith("mbrl_tpu."):
        return "mbrl_tpu_torch." + tree[len("mbrl_tpu."):]
    return tree


def _forwards(jax_wrapper, jax_state, wrapper, state, jax_batch, batch):
    j_in, _ = jax_wrapper.process_batch(jax_state, jax_batch.as_jnp())
    j_mean, j_logvar = jax_wrapper.model.forward(jax_state["params"], j_in)
    with torch.no_grad():
        t_in, _ = wrapper.process_batch(state, batch)
        t_mean, t_logvar = wrapper.model.forward(state["params"], t_in)
    return (np.asarray(j_mean), np.asarray(j_logvar)), (t_mean.numpy(), t_logvar.numpy())


def test_load_run_config_equals_jax(jax_run, tmp_path):
    """On the JAX package's config.yaml the dicts are equal but for the dotted
    paths, which name the port's counterparts; on a config.yaml with the
    port's paths (as the port's CLI writes it) they are equal."""
    jax_dict = jax_common.load_run_config(jax_run)._data
    port = common.load_run_config(jax_run)._data
    assert port == _port_names(jax_dict)
    assert port["dynamics_model"]["_target_"] == "mbrl_tpu_torch.models.GaussianMLP"
    (tmp_path / ".hydra").mkdir()
    with open(tmp_path / ".hydra" / "config.yaml", "w") as f:
        yaml.safe_dump(port, f)
    assert common.load_run_config(tmp_path)._data == jax_common.load_run_config(tmp_path)._data


def test_load_experiment_matches_jax(jax_run):
    jcfg, jenv, jwrapper, jstate, jbuffer, *_ = jax_common.load_experiment(jax_run)
    cfg, env, wrapper, state, buffer, term_fn, reward_fn = common.load_experiment(
        jax_run, device="cpu")
    assert env.observation_space.shape == jenv.observation_space.shape == (4,)
    assert term_fn is not None and reward_fn is not None
    assert buffer.num_stored == jbuffer.num_stored > 0
    jall, tall = jbuffer.get_all(), buffer.get_all()
    for name in ("obs", "act", "next_obs", "rewards", "terminateds", "truncateds"):
        np.testing.assert_array_equal(getattr(tall, name), getattr(jall, name), err_msg=name)
    np.testing.assert_array_equal(state["params"]["elite"].numpy(),
                                  np.asarray(jstate["params"]["elite"]))
    (jm, jl), (tm, tl) = _forwards(jwrapper, jstate, wrapper, state, jall, tall)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=FORWARD_ATOL)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FORWARD_ATOL)
    # cfg= replaces the file read: the same model from the composed config
    cfg2, *_ = common.load_experiment(jax_run, load_buffer=False,
                                      cfg=common.load_run_config(jax_run), device="cpu")
    assert cfg2.dynamics_model.in_size == 5


def test_dataset_evaluator_matches_jax(jax_run, tmp_path):
    from mbrl_tpu.diagnostics import DatasetEvaluator as JaxDatasetEvaluator

    jev = JaxDatasetEvaluator(str(jax_run), str(jax_run), str(tmp_path / "jax"))
    ev = DatasetEvaluator(str(jax_run), str(jax_run), str(tmp_path / "port"), device="cpu")
    # the same buffer shuffle in both (each draws a permutation from its rng)
    jev.replay_buffer._rng = np.random.default_rng(3)
    ev.replay_buffer._rng = np.random.default_rng(3)
    means, targets = ev.predict(ev.dataset())
    # the JAX evaluator's prediction pass (eval_model_on_dataset.py:40-55)
    import mbrl_tpu.util.common as jax_util_common

    jdata, _ = jax_util_common.get_basic_buffer_iterators(
        jev.replay_buffer, 32, 0, ensemble_size=1, shuffle_each_epoch=False)
    jdata.toggle_bootstrap()
    jm, jt = [], []
    for batch in jdata:
        model_in, target = jev.dynamics_model.process_batch(jev.model_state, batch.as_jnp())
        mean, _ = jev.dynamics_model.model.forward(jev.model_state["params"], model_in)
        jm.append(np.asarray(mean))
        jt.append(np.asarray(target))
    jm, jt = np.concatenate(jm, axis=1), np.concatenate(jt, axis=0)
    assert means.shape == jm.shape == (7, jev.replay_buffer.num_stored, 4)
    np.testing.assert_allclose(means, jm, rtol=0, atol=FORWARD_ATOL)
    np.testing.assert_allclose(targets, jt, rtol=0, atol=FORWARD_ATOL)
    ev.plot(means, targets)
    jev.run()
    names = sorted(p.name for p in (tmp_path / "port").glob("pred_dim*.png"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("pred_dim*.png"))
    assert len(names) == 4


def test_visualizer_real_part_matches_jax(run_dir):
    from mbrl_tpu.diagnostics import Visualizer as JaxVisualizer

    jvis = JaxVisualizer(lookahead=5, results_dir=str(run_dir), num_steps=5, num_model_samples=2)
    vis = Visualizer(lookahead=5, results_dir=str(run_dir), num_steps=5, num_model_samples=2,
                     device="cpu")
    obs = np.array([0.01, -0.02, 0.03, 0.015], np.float32)
    plan = np.random.default_rng(0).uniform(-1, 1, (5, 1)).astype(np.float32)
    for env in (jvis.env, vis.env):
        env.reset(seed=0)
        env.unwrapped.state = obs.astype(np.float64)
    j_real, _, _ = jvis.handler.rollout_env(jvis.env, obs, 5, plan=plan)
    real, model = vis.rollouts(obs, plan)
    np.testing.assert_array_equal(real, j_real)
    assert model.shape == (6, 2, 4) and np.isfinite(model).all()
    # the environment is where it started (the rollout ran in a freeze)
    np.testing.assert_array_equal(vis.env.unwrapped.state, obs.astype(np.float64))
    # with the run's planner: one plan every lookahead steps, one PNG each
    planner = Visualizer(lookahead=4, results_dir=str(run_dir), agent_dir=str(run_dir),
                         num_steps=8, num_model_samples=2, device="cpu")
    assert isinstance(planner.agent, TrajectoryOptimizerAgent)
    rollouts = planner.compute()
    assert [r[0] for r in rollouts] == [0, 4]
    assert all(r[2].shape == (5, 2, 4) for r in rollouts)
    planner.plot(rollouts)
    assert sorted(p.name for p in (run_dir / "diagnostics").glob("pred_step*.png")) == [
        "pred_step000.png", "pred_step001.png"]


@pytest.mark.parametrize("agent_type", ["planner", "random"])
def test_finetuner_writes_a_model_both_packages_load(run_dir, agent_type):
    from mbrl_tpu.config import create_one_dim_tr_model as jax_create_model

    ft = FineTuner(str(run_dir), str(run_dir), agent_type=agent_type, device="cpu")
    stored = ft.replay_buffer.num_stored
    ft.run(batch_size=16, val_ratio=0.1, num_epochs=2, patience=2, steps_to_collect=4)
    out = run_dir / "finetune"
    assert {"model.pkl", "replay_buffer.npz", "finetune_losses.npz"} <= {
        p.name for p in out.iterdir()}
    losses = np.load(out / "finetune_losses.npz")
    assert losses["train"].size == 2 and np.isfinite(losses["train"]).all()
    assert np.isfinite(losses["val"]).all()
    # the fine-tuned model loads in both packages and predicts alike
    jcfg = jax_common.load_run_config(run_dir)
    jwrapper = jax_create_model(jcfg, (4,), (1,))
    jstate = jwrapper.load(jwrapper.init(jax.random.PRNGKey(0)), out)
    cfg = common.load_run_config(run_dir)
    from mbrl_tpu_torch.config import create_one_dim_tr_model

    wrapper = create_one_dim_tr_model(cfg, (4,), (1,), device="cpu")
    state = wrapper.load(wrapper.init(torch.Generator().manual_seed(0)), out)
    # the JAX package keeps the saved float64 statistics in float32
    np.testing.assert_array_equal(state["normalizer"].mean.numpy().astype(np.float32),
                                  np.asarray(jstate["normalizer"].mean))
    from mbrl_tpu.util.replay_buffer import ReplayBuffer as JaxReplayBuffer

    jbuffer = JaxReplayBuffer(cfg.overrides.num_steps, (4,), (1,))
    jbuffer.load(out)
    assert jbuffer.num_stored == min(stored + 4, cfg.overrides.num_steps)
    batch = jbuffer.get_all()
    (jm, _), (tm, _) = _forwards(jwrapper, jstate, wrapper, state, batch, batch)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=FORWARD_ATOL)


def test_load_agent_pets_from_a_jax_run(jax_run):
    from mbrl_tpu.planning import load_agent as jax_load_agent

    jcfg, jenv, jwrapper, jstate, jbuffer, *_ = jax_common.load_experiment(jax_run)
    env = common.load_experiment(jax_run, load_buffer=False, device="cpu")[1]
    agent = load_agent(jax_run, env, device="cpu")
    assert isinstance(agent, TrajectoryOptimizerAgent) and agent._seed == 1
    jagent = jax_load_agent(jax_run, jenv)
    batch = jbuffer.get_all()
    wrapper = agent.trajectory_eval_fn.__closure__[0].cell_contents.dynamics_model
    (jm, jl), (tm, tl) = _forwards(jwrapper, jagent._eval_state, wrapper, agent._eval_state,
                                   batch, batch)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=FORWARD_ATOL)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=FORWARD_ATOL)
    obs, _ = env.reset(seed=0)
    for _ in range(3):
        action = agent.act(obs)
        assert action.shape == (1,) and np.all(np.abs(action) <= 1.0)
        obs, *_ = env.step(action)
    # cfg= replaces the file read
    again = load_agent(jax_run, env, cfg=common.load_run_config(jax_run), device="cpu")
    assert again._seed == 1


def test_packaging_matches_jax(jax_run, tmp_path):
    from mbrl_tpu.util import huggingface as jax_hf

    jpkg = jax_hf.package_experiment(str(jax_run), str(tmp_path / "jax"))
    pkg = hf.package_experiment(str(jax_run), str(tmp_path / "port"))
    assert sorted(p.name for p in pkg.iterdir()) == sorted(p.name for p in jpkg.iterdir())
    meta, jmeta = (json.loads((d / "metadata.json").read_text()) for d in (pkg, jpkg))
    assert meta.pop("library") == "mbrl_tpu_torch" and jmeta.pop("library") == "mbrl_tpu"
    assert json.dumps(meta) == json.dumps(jmeta)  # NaN rewards compare as text
    lines = (pkg / "README.md").read_text().splitlines()
    jlines = (jpkg / "README.md").read_text().splitlines()
    assert len(lines) == len(jlines)
    differ = [(a, b) for a, b in zip(lines, jlines) if a != b]
    assert [a for a, _ in differ] == [
        "library_name: mbrl_tpu_torch",
        "This is a trained model produced by **mbrl_tpu_torch**, the PyTorch/CUDA",
        "port of mbrl_tpu, a model-based reinforcement learning framework with the",
        "from mbrl_tpu_torch.util.huggingface import load_model_from_package",
    ]
    # the card with eval numbers and a video, as tests/test_diagnostics.py checks it
    card = hf._render_card("pets", "cartpole", 123.4, 5.6, has_video=True)
    expected = jax_hf._render_card("pets", "cartpole", 123.4, 5.6, True)
    for port_line, jax_line in differ:
        expected = expected.replace(jax_line, port_line)
    assert card == expected and "model-index:" in card and 'src="replay.mp4"' in card
    payload = hf.load_model_from_package(pkg, device="cpu")
    jpayload = jax_hf.load_model_from_package(jpkg)
    batch = jax_common.load_experiment(jax_run)[4].get_all()
    (jm, _), (tm, _) = _forwards(jpayload["model"], jpayload["state"], payload["model"],
                                 payload["state"], batch, batch)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=FORWARD_ATOL)


def test_evaluate_agent_records_the_first_episode(tmp_path):
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from test_torch_video import RenderingLineEnv

    from mbrl_tpu_torch.planning import RandomAgent
    from mbrl_tpu_torch.util.video import VideoRecorder

    env = RenderingLineEnv()
    rec = VideoRecorder(tmp_path)
    mean, std = hf.evaluate_agent(env, RandomAgent(env), num_episodes=1, video_recorder=rec)
    assert np.isfinite(mean) and std == 0
    assert len(rec.frames) == 30 and rec.enabled  # MockLineEnv's 30 steps
    # a later episode re-inits the recorder disabled (as in the JAX package)
    hf.evaluate_agent(env, RandomAgent(env), num_episodes=2, video_recorder=rec)
    assert not rec.enabled and rec.frames == []


def test_true_dynamics_controller_plan_in_bounds():
    """tests/test_diagnostics.py:141-155: one plan on the real environment."""
    ctrl = TrueDynamicsController(
        "cartpole_continuous", horizon=6, population_size=16, num_iterations=2,
        num_workers=2, seed=0, device="cpu",
    )
    try:
        state = ctrl.handler.get_current_state(ctrl.env)
        plan = ctrl.plan(state)
        assert plan.shape == (6, 1)
        assert np.all(plan >= -1) and np.all(plan <= 1)
        # the planner's environment is where it was: the workers stepped their own
        np.testing.assert_array_equal(ctrl.handler.get_current_state(ctrl.env)[0]["state"],
                                      state[0]["state"])
    finally:
        ctrl.close()


def test_training_browser_aggregate_equals_jax(tmp_path):
    from mbrl_tpu.diagnostics import training_browser as jax_browser

    for seed in range(3):
        run = tmp_path / "pets" / "default" / "cartpole" / "2026.01.01" / f"00000{seed}"
        run.mkdir(parents=True)
        steps = np.arange(0, 1000 + 100 * seed, 100)
        rewards = np.sqrt(steps) * (1 + 0.1 * seed)
        with open(run / "results.csv", "w") as f:
            f.write("env_step,episode_reward\n")
            for s, r in zip(steps, rewards):
                f.write(f"{s},{r}\n")
    files = training_browser.find_results_files([str(tmp_path)])
    assert files == jax_browser.find_results_files([str(tmp_path)]) and len(files) == 3
    groups = training_browser.group_runs(files)
    assert groups == jax_browser.group_runs(files)
    for got, want in zip(training_browser.aggregate(files), jax_browser.aggregate(files)):
        np.testing.assert_array_equal(got, want)
    out = tmp_path / "curves.png"
    training_browser.plot_groups(groups, output=str(out))
    assert out.exists()
