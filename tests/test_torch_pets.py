"""The port's PETS loop on the CPU: the numpy cartpole against mbrl_tpu's step
for step, a short ``pets.train`` on a mock double integrator through both
retraining routes with resume from a checkpoint, and the convergence runs
against mbrl_tpu's tests/test_algorithms.py threshold (reward > -0.02)."""
import pathlib

import numpy as np
import pytest
import torch

import mbrl_tpu_torch.algorithms.pets as pets
from mbrl_tpu_torch.config import load_config
from mbrl_tpu_torch.config.engine import resolve_interpolations
from mbrl_tpu_torch.envs.cartpole_continuous import CartPoleEnv
from mbrl_tpu_torch.envs.spaces import Box
from mbrl_tpu_torch.models import GaussianMLP, TransitionRewardModel
from mbrl_tpu_torch.planning import RandomAgent
from mbrl_tpu_torch.util import checkpoint as ckpt
from mbrl_tpu_torch.util import common as util_common
from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer
from mbrl_tpu_torch.util.runlock import RunLockedError, run_lock

_TRIAL_LEN = 30
_REW_C = 0.001
_INITIAL_EXPLORE = 500
_TARGET_REWARD = -20 * _REW_C
_CONF_DIR = pathlib.Path(__file__).parent.parent / "mbrl_tpu_torch" / "examples" / "conf"
SEED = 12345


class MockLineEnv:
    """Point mass starts at 1.0 and must return to 0.0; reward -c*pos^2."""

    def __init__(self):
        self.observation_space = Box(-np.inf * np.ones(2), np.inf * np.ones(2), shape=(2,),
                                     dtype=np.float64, seed=SEED)
        self.action_space = Box(-np.ones(1), np.ones(1), shape=(1,), dtype=np.float64, seed=SEED)

    def reset(self, seed=None, options=None):
        self.pos, self.vel, self.time_left = 1.0, 0.0, _TRIAL_LEN
        return np.array([self.pos, self.vel]), {}

    def step(self, action):
        self.vel += action.item()
        self.pos += self.vel
        self.time_left -= 1
        reward = -_REW_C * (self.pos**2)
        return np.array([self.pos, self.vel]), reward, self.time_left == 0, False, {}


def mock_reward_fn(action, obs):
    return (-_REW_C * (obs[:, 0] ** 2))[:, None]


def mock_term_fn(act, next_obs):
    return torch.zeros((next_obs.shape[0], 1), dtype=torch.bool, device=next_obs.device)


def _pets_cfg(extra_overrides=(), device_training=True):
    cfg = load_config(_CONF_DIR, "main",
                      overrides=["algorithm=pets", "overrides=pets_cartpole", *extra_overrides])
    cfg.seed = SEED
    # test-scale problem: mbrl_tpu's test overrides. As there, the values that
    # main.yaml interpolates elsewhere (planning horizon, CEM sizes, retraining
    # cadence) were resolved by load_config and keep pets_cartpole's; the budget,
    # batch size, epochs and patience are read from `overrides` and do change.
    # as in mbrl_tpu's test; the loop counts planned steps only, so this is 21
    # trials of planning after the exploration
    cfg.overrides["num_steps"] = _TRIAL_LEN * 5 + _INITIAL_EXPLORE
    cfg.overrides["trial_length"] = _TRIAL_LEN
    cfg.overrides["model_batch_size"] = 128
    cfg.overrides["num_epochs_train_model"] = 10
    cfg.overrides["patience"] = 5
    cfg.overrides["freq_train_model"] = 30
    cfg.overrides["planning_horizon"] = 10
    cfg.overrides["cem_num_iters"] = 5
    cfg.overrides["cem_population_size"] = 150
    cfg.algorithm["initial_exploration_steps"] = _INITIAL_EXPLORE
    cfg.algorithm["num_particles"] = 5
    cfg.algorithm["device_model_training"] = device_training
    cfg.dynamics_model["hid_size"] = 64
    cfg.dynamics_model["num_layers"] = 2
    resolve_interpolations(cfg)
    return cfg


def _optimizer_cfg(optimizer, device_training=True):
    if optimizer == "cem":
        return _pets_cfg(device_training=device_training)
    cfg = _pets_cfg([f"action_optimizer={optimizer}"], device_training)
    cfg.overrides["planning_horizon"] = 15
    if optimizer == "icem":  # mbrl_tpu's iCEM test hyperparameters
        cfg.overrides["cem_population_decay_factor"] = 1.3
        cfg.overrides["cem_colored_noise_exponent"] = 2.0
        cfg.overrides["cem_keep_elite_frac"] = 0.3
        cfg.overrides["cem_population_size"] = 350
        cfg.overrides["num_epochs_train_model"] = 20
        cfg.overrides["patience"] = 8
    else:  # overrides/pets_mppi_halfcheetah.yaml's MPPI values
        for key, value in dict(mppi_num_iters=5, mppi_population_size=350, mppi_gamma=0.9,
                               mppi_sigma=1.0, mppi_beta=0.9).items():
            cfg.overrides[key] = value
    resolve_interpolations(cfg)
    return cfg


# --------------------------------------------------------------------------- #
def test_cartpole_follows_the_jax_package_step_for_step():
    from mbrl_tpu.envs.cartpole_continuous import CartPoleEnv as JaxCartPole

    jenv, tenv = JaxCartPole(), CartPoleEnv()
    assert tenv.observation_space.shape == jenv.observation_space.shape == (4,)
    np.testing.assert_array_equal(tenv.observation_space.high, jenv.observation_space.high)
    np.testing.assert_array_equal(tenv.action_space.low, jenv.action_space.low)
    assert tenv.action_space.shape == (1,) and tenv.action_space.dtype == np.float32
    rng = np.random.default_rng(0)
    for seed in (1, 2):
        jobs, jinfo = jenv.reset(seed=seed)
        tobs, tinfo = tenv.reset(seed=seed)
        np.testing.assert_allclose(tobs, jobs, atol=1e-6)
        assert tobs.dtype == np.float32 and tinfo == {} == jinfo
        done_steps = 0
        for _ in range(150):
            action = rng.uniform(-1.5, 1.5, size=1).astype(np.float32)  # clipped inside
            jout, tout = jenv.step(action), tenv.step(action)
            np.testing.assert_allclose(tout[0], jout[0], atol=1e-6)
            assert tout[1:] == jout[1:]
            done_steps += tout[2]
            if done_steps > 3:  # a few steps past termination: reward 1, then 0
                break
        assert done_steps > 3 and tout[1] == 0.0
    # unseeded resets go on from the generator the last seed made
    np.testing.assert_allclose(tenv.reset()[0], jenv.reset()[0], atol=1e-6)


def test_box_space():
    box = Box(-np.ones(3), np.ones(3), dtype=np.float32, seed=0)
    samples = np.stack([box.sample() for _ in range(200)])
    assert samples.dtype == np.float32 and box.shape == (3,)
    assert (np.abs(samples) <= 1).all() and samples.std() > 0.4
    again = Box(-np.ones(3), np.ones(3), dtype=np.float32, seed=0)
    np.testing.assert_array_equal(again.sample(), samples[0])
    box.seed(0)
    np.testing.assert_array_equal(box.sample(), samples[0])
    unbounded = Box(-np.inf, np.inf, shape=(2,))
    assert np.isfinite(unbounded.sample()).all()
    assert (RandomAgent(CartPoleEnv()).act(None) <= 1).all()


def test_rollout_helpers_fill_the_buffer():
    env = CartPoleEnv()
    env.action_space.seed(0)
    buffer = ReplayBuffer(100, (4,), (1,))
    seen = []
    rewards = util_common.rollout_agent_trajectories(env, 60, RandomAgent(env), {}, replay_buffer=buffer,
                                                     callback=seen.append, seed=3)
    assert buffer.num_stored == 60 == len(seen) and sum(rewards) == 60.0
    trials = util_common.rollout_agent_trajectories(env, 3, RandomAgent(env), {}, trial_length=5,
                                                    collect_full_trajectories=True)
    assert len(trials) == 3
    tracking = ReplayBuffer(100, (4,), (1,), max_trajectory_length=20)
    with pytest.raises(RuntimeError, match="trajectory"):
        util_common.rollout_agent_trajectories(env, 5, RandomAgent(env), {}, replay_buffer=tracking)
    # rollout_model_env: a plan rolled inside the model
    from mbrl_tpu_torch.envs import termination_fns
    from mbrl_tpu_torch.models import ModelEnv

    wrapper = TransitionRewardModel(GaussianMLP(5, 5, 2, 3, 16, propagation_method="random_model",
                                                device="cpu"), normalize=True)
    state = wrapper.init(torch.Generator().manual_seed(0))
    obs_hist, rew_hist, plan = util_common.rollout_model_env(
        ModelEnv(wrapper, termination_fns.cartpole), state, np.zeros(4, np.float32),
        torch.Generator().manual_seed(1), plan=np.zeros((6, 1), np.float32), num_samples=3)
    assert obs_hist.shape == (7, 3, 4) and rew_hist.shape == (6, 3, 1) and plan.shape == (6, 1)


def test_run_lock_refuses_a_second_live_trainer(tmp_path):
    import os

    with run_lock(tmp_path):
        assert (tmp_path / ".run_lock").read_text() == str(os.getpid())
        with run_lock(tmp_path):  # re-entrant within one process
            pass
        assert (tmp_path / ".run_lock").exists()
    assert not (tmp_path / ".run_lock").exists()
    (tmp_path / ".run_lock").write_text("1")  # pid 1 is alive
    with pytest.raises(RunLockedError):
        with run_lock(tmp_path):
            pass
    (tmp_path / ".run_lock").write_text("999999999")  # a dead pid: the lock is stolen
    with run_lock(tmp_path):
        pass


def test_checkpoint_round_trip_and_refusal_of_non_finite_state(tmp_path):
    wrapper = TransitionRewardModel(GaussianMLP(5, 4, 2, 3, 8, device="cpu"), normalize=True,
                                    normalize_double_precision=True)
    g = torch.Generator().manual_seed(4)
    state = wrapper.init(g)
    state["opt_state"] = torch.optim.Adam([torch.zeros(2, requires_grad=True)]).state_dict()
    payload = {"model_state": state, "generators": {"model": ckpt.generator_state(g)},
               "env_steps": 7, "max_total_reward": None}
    for step in (10, 20, 30, 40):
        path = ckpt.save_checkpoint(tmp_path, payload, step=step)
    assert ckpt.latest_checkpoint(tmp_path) == path and path.name == "step_40.pkl"
    assert sorted(p.name for p in path.parent.iterdir()) == ["step_20.pkl", "step_30.pkl",
                                                             "step_40.pkl"]
    back = ckpt.restore_checkpoint(path, device="cpu")
    assert back["env_steps"] == 7 and back["max_total_reward"] is None
    assert torch.equal(back["model_state"]["params"]["head"]["w"], state["params"]["head"]["w"])
    assert back["model_state"]["params"]["elite"].dtype == torch.int64
    assert back["model_state"]["normalizer"].mean.dtype == torch.float64
    assert back["model_state"]["opt_state"]["param_groups"][0]["lr"] == 1e-3
    want = torch.randn(3, generator=g)
    fresh = torch.Generator()
    ckpt.set_generator_state(fresh, back["generators"]["model"])
    assert torch.equal(torch.randn(3, generator=fresh), want)
    state["params"]["head"]["w"][0, 0, 0] = float("nan")
    with pytest.raises(ckpt.NonFiniteCheckpointError):
        ckpt.save_checkpoint(tmp_path, payload, step=50)
    assert ckpt.latest_checkpoint(tmp_path / "nowhere") is None


def test_logger_writes_group_csv(tmp_path):
    from mbrl_tpu_torch.constants import EVAL_LOG_FORMAT, RESULTS_LOG_NAME
    from mbrl_tpu_torch.util.logger import Logger

    logger = Logger(tmp_path)
    logger.register_group(RESULTS_LOG_NAME, EVAL_LOG_FORMAT, color="green")
    logger.log_data(RESULTS_LOG_NAME, {"env_step": 3, "episode_reward": 1.5})
    logger.close()
    assert (tmp_path / "results.csv").read_text().splitlines() == ["env_step,episode_reward", "3,1.5"]


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("setting,value", [("parallel", {"enable": True}),
                                           ("num_env_workers", 2)])
def test_unported_settings_raise(setting, value, tmp_path):
    cfg = _pets_cfg()
    if setting == "parallel":
        cfg["parallel"] = value
    else:
        cfg.overrides[setting] = value
    with pytest.raises(NotImplementedError, match="parallel/"):
        pets.train(MockLineEnv(), mock_term_fn, mock_reward_fn, cfg, silent=True,
                   work_dir=str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        if torch.cuda.is_available():
            raise RuntimeError("cuda present")
        pets.train(MockLineEnv(), mock_term_fn, mock_reward_fn, _pets_cfg(), silent=True,
                   work_dir=str(tmp_path))


@pytest.mark.parametrize("device_training", [True, False], ids=["train_device", "host_iterators"])
def test_short_pets_run_writes_its_files_and_resumes(device_training, tmp_path):
    """40 planned steps on a narrow model: both retraining routes run, the
    files are written, and a second call resumes from the newest checkpoint."""
    cfg = _pets_cfg(device_training=device_training)
    cfg.overrides["num_steps"] = 40
    cfg.algorithm["dataset_size"] = 1000  # the buffer's capacity, else num_steps
    cfg.overrides["num_epochs_train_model"] = 3
    # load_config resolved the interpolations already: the planner's and the
    # cadence's values are set where they are read
    cfg.algorithm["freq_train_model"] = 20
    cfg.algorithm.agent["planning_horizon"] = 5
    cfg.algorithm.agent.optimizer["population_size"] = 40
    cfg.algorithm.agent.optimizer["num_iterations"] = 2
    cfg.algorithm["initial_exploration_steps"] = 100
    cfg.dynamics_model["hid_size"] = 16
    cfg["checkpoint_every"] = 25
    cfg.algorithm["planning_prng_impl"] = "rbg"  # a JAX key implementation: ignored
    resolve_interpolations(cfg)
    reward = pets.train(MockLineEnv(), mock_term_fn, mock_reward_fn, cfg, silent=False,
                        work_dir=str(tmp_path), device="cpu")
    assert np.isfinite(reward) and reward.dtype == np.float32
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["checkpoint", "model.pkl", "model_train.csv", "replay_buffer.npz", "results.csv"]
    assert len((tmp_path / "results.csv").read_text().splitlines()) == 1 + 2  # two 30-step trials
    rows = (tmp_path / "model_train.csv").read_text().splitlines()
    assert len(rows) == 1 + 3 * 3  # retrained at steps 0, 20, 40: three epochs each
    snap = ckpt.restore_checkpoint(ckpt.latest_checkpoint(tmp_path), device="cpu")
    assert snap["env_steps"] == 50 and snap["current_trial"] == 1
    assert "opt_state" in snap["model_state"] and set(snap["generators"]) == {"model", "agent"}
    # the saved model and buffer load again
    buffer = ReplayBuffer(1000, (2,), (1,), obs_type=np.double, action_type=np.double,
                          reward_type=np.double)
    buffer.load(tmp_path)
    assert buffer.num_stored == 100 + 40  # saved at the last retraining, at step 40
    wrapper = TransitionRewardModel(GaussianMLP(3, 2, 2, 7, 16, device="cpu"), normalize=True,
                                    normalize_double_precision=True, learned_rewards=False)
    loaded = wrapper.load(wrapper.init(torch.Generator().manual_seed(0)), tmp_path)
    assert loaded["params"]["elite"].shape == (5,) and loaded["normalizer"].std.dtype == torch.float64

    # resume: no new exploration, counters restored, the run goes on to the new budget
    cfg["resume"] = True
    cfg.overrides["num_steps"] = 80
    reward2 = pets.train(MockLineEnv(), mock_term_fn, mock_reward_fn, cfg, silent=True,
                         work_dir=str(tmp_path), device="cpu")
    buffer.load(tmp_path)
    # resumed at step 50 on the 140 saved rows; one trial to step 80, saved at step 60
    assert buffer.num_stored == 140 + 10
    assert np.isfinite(reward2)
    assert ckpt.latest_checkpoint(tmp_path).name == "step_75.pkl"


@pytest.fixture
def two_threads():
    """Two intra-op threads for the long runs (they share the machine with the
    other test workers), put back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _converges(optimizer, device_training, tmp_path, planned_trials=None):
    cfg = _optimizer_cfg(optimizer, device_training)
    if planned_trials is not None:
        # the same run cut short: the buffer keeps the full budget's capacity
        cfg.algorithm["dataset_size"] = cfg.overrides.num_steps
        cfg.overrides["num_steps"] = _TRIAL_LEN * planned_trials
    max_reward = pets.train(MockLineEnv(), mock_term_fn, mock_reward_fn, cfg, silent=True,
                            work_dir=str(tmp_path), device="cpu")
    assert max_reward > _TARGET_REWARD, max_reward


def test_pets_cem_mock_line_env_converges(tmp_path, two_threads):
    """The first 12 of the 21 planned trials of mbrl_tpu's budget (the whole
    budget runs in the slow test below): CEM passed the threshold within 5
    trials on each of three seeds tried, and the run stays under a minute."""
    _converges("cem", True, tmp_path, planned_trials=12)


@pytest.mark.slow
@pytest.mark.parametrize("optimizer,device_training", [("cem", True), ("icem", True), ("mppi", True),
                                                        ("cem", False), ("icem", False)])
def test_pets_mock_line_env_converges_slow(optimizer, device_training, tmp_path, two_threads):
    _converges(optimizer, device_training, tmp_path)
