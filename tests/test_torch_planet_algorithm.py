"""The port's ``algorithms/planet.py`` on the CPU: ``planet.train`` end to end
on a pixel mock environment (both training routes) and on dm_control's
cartpole-balance, mid-run resume, and the entry points' device default.

The budget is ``tests/test_planet.py``'s end-to-end one on the port's config
tree. That test writes a CEM of 30 x horizon 3 x 2 iterations into
``overrides``, where the planner, whose interpolations ``load_config`` has
already resolved, never reads it: its runs plan with
``planet_cartpole_balance``'s 1,000 x 12 x 10. Here the written sizes are set
on the agent itself, so that the runs plan at the budget the test states.
"""
import os
import pathlib

import numpy as np
import pytest
import torch

from mbrl_tpu_torch.algorithms import planet as planet_algo
from mbrl_tpu_torch.config import load_config
from mbrl_tpu_torch.config.engine import resolve_interpolations
from mbrl_tpu_torch.models import PlaNetModel
from mbrl_tpu_torch.util import checkpoint as ckpt

from test_torch_planet import BELIEF, DEC_CFG, ENC_CFG, LATENT, OBS_SHAPE, SMALL, MockPixelEnv

CONF = pathlib.Path(__file__).resolve().parent.parent / "mbrl_tpu_torch" / "examples" / "conf"


def _planet_cfg(num_episodes=2, grad_updates=3, **top):
    """tests/test_planet.py's end-to-end budget on the port's config tree."""
    cfg = load_config(CONF, "main", overrides=["algorithm=planet", "dynamics_model=planet",
                                               "overrides=planet_cartpole_balance"])
    cfg.seed = 0
    for k, v in top.items():
        cfg[k] = v
    dm = cfg.dynamics_model
    dm["obs_shape"] = list(OBS_SHAPE)
    dm["obs_encoding_size"] = 64
    dm["encoder_config"] = [list(c) for c in ENC_CFG]
    dm["decoder_config"] = [list(DEC_CFG[0]), [list(c) for c in DEC_CFG[1]]]
    dm["latent_state_size"] = LATENT
    dm["belief_size"] = BELIEF
    dm["hidden_size_fcs"] = 32
    cfg.algorithm["num_initial_trajectories"] = 2
    cfg.algorithm["num_episodes"] = num_episodes
    cfg.algorithm["dataset_size"] = 2000
    ov = cfg.overrides
    ov["trial_length"] = 10
    ov["num_grad_updates"] = grad_updates
    ov["sequence_length"] = 5
    ov["batch_size"] = 4
    ov["planning_horizon"] = 3
    ov["cem_num_iters"] = 2
    ov["cem_population_size"] = 30
    resolve_interpolations(cfg)
    agent = cfg.algorithm.agent
    agent["planning_horizon"] = 3
    agent.optimizer["num_iterations"] = 2
    agent.optimizer["population_size"] = 30
    return cfg


@pytest.mark.parametrize("device_training", [True, False], ids=["device_route", "host_route"])
def test_planet_end_to_end_on_mock_pixel_env(tmp_path, device_training):
    cfg = _planet_cfg()
    cfg.algorithm["device_model_training"] = device_training
    avg = planet_algo.train(MockPixelEnv(), cfg, silent=False, work_dir=str(tmp_path), device="cpu")
    assert np.isfinite(avg)
    assert (tmp_path / "planet.pkl").exists()
    rows = (tmp_path / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 3 and "observations_loss" in rows[0]
    assert all(np.isfinite(float(x)) for r in rows[1:] for x in r.split(","))
    # the device route logs a model_train row a call; the host route's
    # train(evaluate=False) logs none, as the JAX package's
    rows = (tmp_path / "model_train.csv").read_text().strip().splitlines()
    assert len(rows) == (3 if device_training else 1)


def test_planet_mid_run_resume(tmp_path):
    """Stop after episode 1, resume, continue to episode 3: the checkpoint
    carries params, Adam's state, both generators and the counters, and the
    resumed run skips the initial exploration."""
    def cfg_for(n):
        return _planet_cfg(num_episodes=n, grad_updates=2, resume=True, checkpoint_every=1)

    planet_algo.train(MockPixelEnv(), cfg_for(1), silent=True, work_dir=str(tmp_path), device="cpu")
    snap = ckpt.restore_checkpoint(ckpt.latest_checkpoint(tmp_path), device="cpu")
    assert int(snap["episode"]) == 1 and int(snap["step"]) == 30
    assert "opt_state" in snap["planet_state"]
    assert set(snap["generators"]) == {"model", "agent"}
    planet_algo.train(MockPixelEnv(), cfg_for(3), silent=True, work_dir=str(tmp_path), device="cpu")
    snap2 = ckpt.restore_checkpoint(ckpt.latest_checkpoint(tmp_path), device="cpu")
    assert int(snap2["episode"]) == 3 and int(snap2["step"]) == 50


def test_planet_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        PlaNetModel(**SMALL)
    with pytest.raises(RuntimeError, match="cuda"):
        planet_algo.train(MockPixelEnv(), _planet_cfg(), silent=True, work_dir=str(tmp_path))
    # parallel=mesh runs, on the CPU too: one process is a 1 x 1 mesh
    cfg = _planet_cfg()
    cfg["parallel"] = {"enable": True}
    assert np.isfinite(planet_algo.train(MockPixelEnv(), cfg, silent=True, work_dir=str(tmp_path),
                                         device="cpu"))


def test_planet_on_dm_control_cartpole_balance(tmp_path):
    """The first frames of both packages' DmControlEnv from one seed are the
    same, and a short planet.train on dmcontrol___cartpole--balance at 32x32
    (the override's env_cfg through util.env.make_env) ends finite."""
    os.environ.setdefault("MUJOCO_GL", "egl")
    pytest.importorskip("dm_control")
    from mbrl_tpu.util.dmcontrol_wrapper import DmControlEnv as JaxDmControlEnv
    from mbrl_tpu_torch.util.dmcontrol_wrapper import DmControlEnv
    from mbrl_tpu_torch.util.env import make_env

    kw = dict(from_pixels=True, height=32, width=32, frame_skip=8, bit_depth=5, seed=3)
    envs = [DmControlEnv("cartpole", "balance", **kw), JaxDmControlEnv("cartpole", "balance", **kw)]
    first = [env.reset()[0] for env in envs]
    np.testing.assert_array_equal(first[0], first[1])
    assert first[0].shape == OBS_SHAPE and first[0].dtype == np.uint8
    assert (first[0] % 8 == 0).all()  # 5 bits a channel
    act = np.full(1, 0.3, np.float32)
    steps = [env.step(act) for env in envs]
    np.testing.assert_array_equal(steps[0][0], steps[1][0])
    assert steps[0][1:4] == steps[1][1:4]

    cfg = _planet_cfg()
    cfg.overrides.env_cfg["height"] = 32
    cfg.overrides.env_cfg["width"] = 32
    env, term_fn, reward_fn = make_env(cfg)
    assert env.observation_space.shape == OBS_SHAPE and env.action_space.shape == (1,)
    assert reward_fn is None
    avg = planet_algo.train(env, cfg, silent=True, work_dir=str(tmp_path), device="cpu")
    assert np.isfinite(avg)
