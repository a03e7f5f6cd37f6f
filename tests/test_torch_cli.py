"""``python -m mbrl_tpu_torch.examples.main`` in a subprocess on the CPU, at
tiny budgets: PETS on ``pets_halfcheetah`` (the port's MuJoCo HalfCheetahEnv),
MBPO on ``mbpo_halfcheetah`` (``gym___HalfCheetah-v5``) and PlaNet on
``planet_cartpole_balance`` (dm_control). Each run writes its files, and its
``config.yaml`` is the JAX package's composition of the same arguments with
the targets re-pointed at the port."""
import os
import pathlib
import subprocess
import sys

import pytest
import yaml

from mbrl_tpu.config import load_config as jax_load_config
from mbrl_tpu.config import to_dict as jax_to_dict
from mbrl_tpu_torch.examples.main import split_device

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_CONF = REPO / "mbrl_tpu" / "examples" / "conf"

pytest.importorskip("mujoco")

CASES = {
    "pets": [
        "algorithm=pets", "overrides=pets_halfcheetah",
        "overrides.num_steps=40", "overrides.trial_length=20",
        "algorithm.initial_exploration_steps=20", "overrides.freq_train_model=20",
        "overrides.cem_population_size=20", "overrides.planning_horizon=4",
        "overrides.cem_num_iters=2", "algorithm.num_particles=5",
        "overrides.num_epochs_train_model=2", "overrides.model_batch_size=16",
        "dynamics_model.hid_size=16", "dynamics_model.num_layers=2",
    ],
    "mbpo": [
        "algorithm=mbpo", "overrides=mbpo_halfcheetah",
        "overrides.num_steps=40", "overrides.epoch_length=20", "overrides.freq_train_model=20",
        "overrides.effective_model_rollouts_per_step=4", "overrides.rollout_schedule=[1,3,1,3]",
        "overrides.num_sac_updates_per_step=2", "overrides.model_batch_size=16",
        "overrides.num_epochs_train_model=2", "overrides.sac_hidden_size=16",
        "overrides.sac_batch_size=16", "algorithm.initial_exploration_steps=30",
        "algorithm.num_eval_episodes=1", "dynamics_model.hid_size=16",
        "dynamics_model.num_layers=2",
    ],
    "planet": [
        "algorithm=planet", "dynamics_model=planet", "overrides=planet_cartpole_balance",
        "algorithm.num_initial_trajectories=2", "algorithm.num_episodes=1",
        "algorithm.dataset_size=200", "overrides.trial_length=8",
        "overrides.num_grad_updates=2", "overrides.sequence_length=4", "overrides.batch_size=2",
        "overrides.planning_horizon=3", "overrides.cem_num_iters=2",
        "overrides.cem_population_size=20",
        "dynamics_model.obs_encoding_size=64",
        "dynamics_model.encoder_config=[[3,8,4,2],[8,8,4,2],[8,16,4,2],[16,16,4,2]]",
        "dynamics_model.decoder_config=[[64,1,1],[[64,16,5,2],[16,8,5,2],[8,8,6,2],[8,3,6,2]]]",
        "dynamics_model.belief_size=16", "dynamics_model.latent_state_size=8",
        "dynamics_model.hidden_size_fcs=16",
    ],
}
FILES = {"pets": ("model.pkl", "results.csv", "model_train.csv"),
         "mbpo": ("sac.pkl", "results.csv", "model_train.csv"),
         "planet": ("planet.pkl", "metrics.csv")}


def _repointed(tree):
    if isinstance(tree, dict):
        return {k: _repointed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_repointed(v) for v in tree]
    if isinstance(tree, str) and tree.startswith("mbrl_tpu."):
        return "mbrl_tpu_torch." + tree[len("mbrl_tpu."):]
    return tree


@pytest.mark.parametrize("algorithm", list(CASES))
def test_cli_runs_each_algorithm_and_writes_the_jax_composition(algorithm, tmp_path):
    args = CASES[algorithm] + [f"root_dir={tmp_path}"]
    env = {**os.environ, "MUJOCO_GL": os.environ.get("MUJOCO_GL", "egl")}
    out = subprocess.run([sys.executable, "-m", "mbrl_tpu_torch.examples.main", *args,
                          "device=cpu"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    (config,) = list(tmp_path.rglob("config.yaml"))
    run_dir = config.parent
    # <root_dir>/<algorithm>/<experiment>/<env>/<date>/<time>
    assert run_dir.relative_to(tmp_path).parts[:2] == (algorithm, "default")
    for name in FILES[algorithm]:
        assert (run_dir / name).exists(), name
    got = yaml.safe_load(config.read_text())
    want = _repointed(jax_to_dict(jax_load_config(JAX_CONF, "main", overrides=args)))
    assert got == want
    assert "device" not in got


def test_device_argument_is_taken_off_before_composing():
    assert split_device(["algorithm=pets", "device=cpu", "seed=3"]) == ("cpu", ["algorithm=pets", "seed=3"])
    assert split_device(["overrides.device_thing=1"]) == ("cuda", ["overrides.device_thing=1"])
