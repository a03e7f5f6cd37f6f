"""The port's environments, ``make_env`` and handlers against the JAX
package's, on the CPU.

Both resolve a name in one order: a custom name (``_CUSTOM_ENVS``) first,
then ``overrides.env_cfg``, then the prefixes, then an environment class
registered in the envs package. Each MuJoCo environment, built by both
packages from one state, follows the same 20 actions to equal observations,
rewards and flags; the handlers freeze, restore and roll out as the JAX
package's do, bare and inside either ``TimeLimit``; the pixel wrapper renders
the same frames.
"""
import numpy as np
import pytest
import torch

import mbrl_tpu.envs as jax_envs
import mbrl_tpu_torch.config as torch_config
import mbrl_tpu_torch.envs as torch_envs
from mbrl_tpu.config import Config as JaxConfig
from mbrl_tpu.config import load_config as jax_load_config
from mbrl_tpu.util import env as jax_env
from mbrl_tpu_torch.config import Config as TorchConfig
from mbrl_tpu_torch.config import load_config
from mbrl_tpu_torch.envs.time_limit import TimeLimit
from mbrl_tpu_torch.util import env as torch_env

pytest.importorskip("mujoco")

CONF = torch_env.__file__.rsplit("/util/", 1)[0] + "/examples/conf"
JAX_CONF = jax_env.__file__.rsplit("/util/", 1)[0] + "/examples/conf"


def _cfgs(env: str, env_cfg: bool = False):
    """The same overrides for both packages; ``env_cfg`` targets each one's
    continuous cartpole."""
    def one(config, package):
        overrides = {"env": env}
        if env_cfg:
            overrides["env_cfg"] = {"_target_": f"{package}.envs.cartpole_continuous.CartPoleEnv"}
        return config({"overrides": overrides})

    return one(JaxConfig, "mbrl_tpu"), one(TorchConfig, "mbrl_tpu_torch")


@pytest.fixture
def no_env_cfg(monkeypatch):
    """Fails the test if the port instantiates ``env_cfg``."""
    def refuse(*a, **kw):
        raise AssertionError("env_cfg was instantiated")

    monkeypatch.setattr(torch_config, "instantiate", refuse)


@pytest.mark.parametrize("name", ["pets_halfcheetah", "pets_cartpole", "pets_reacher"])
def test_a_custom_name_comes_before_env_cfg(name, no_env_cfg):
    jax_cfg, torch_cfg = _cfgs(name, env_cfg=True)
    ours = torch_env.make_env_from_name(torch_cfg, name)
    ref = jax_env.make_env_from_name(jax_cfg, name)
    assert isinstance(ours, getattr(torch_envs, torch_env._CUSTOM_ENVS[name]))
    assert isinstance(ref, getattr(jax_envs, jax_env._CUSTOM_ENVS[name]))
    assert not isinstance(ours, torch_envs.CartPoleEnv)
    assert not isinstance(ref, jax_envs.CartPoleEnv)
    assert ours.observation_space.shape == ref.observation_space.shape
    ours.close()
    ref.close()


def test_cartpole_continuous_comes_before_env_cfg(no_env_cfg):
    jax_cfg, torch_cfg = _cfgs("cartpole_continuous", env_cfg=True)
    assert type(torch_env.make_env_from_name(torch_cfg, "cartpole_continuous")) is torch_envs.CartPoleEnv
    assert type(jax_env.make_env_from_name(jax_cfg, "cartpole_continuous")) is jax_envs.CartPoleEnv


def test_env_cfg_builds_an_unlisted_name():
    jax_cfg, torch_cfg = _cfgs("my_cartpole", env_cfg=True)
    assert type(torch_env.make_env_from_name(torch_cfg, "my_cartpole")) is torch_envs.CartPoleEnv
    assert type(jax_env.make_env_from_name(jax_cfg, "my_cartpole")) is jax_envs.CartPoleEnv


def test_the_custom_names_are_the_references():
    assert torch_env._CUSTOM_ENVS == jax_env._CUSTOM_ENVS


def test_the_envs_package_fallback_builds_the_same_cartpole():
    jax_cfg, torch_cfg = _cfgs("CartPoleEnv")
    ours = torch_env.make_env_from_name(torch_cfg, "CartPoleEnv")
    ref = jax_env.make_env_from_name(jax_cfg, "CartPoleEnv")
    assert type(ours) is torch_envs.CartPoleEnv and type(ref) is jax_envs.CartPoleEnv
    for a, b in ((ours.observation_space, ref.observation_space), (ours.action_space, ref.action_space)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    # the same dynamics on one state and action
    rng = np.random.default_rng(0)
    for _ in range(5):
        state = rng.uniform(-0.2, 0.2, 4)
        action = rng.uniform(-1, 1, 1).astype(np.float32)
        ours.state, ref.state = state.copy(), state.copy()
        got, want = ours.step(action), ref.step(action)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]


@pytest.mark.parametrize("name", torch_envs.MUJOCO_ENVS)
def test_a_lazy_mujoco_name_raises_not_implemented(name):
    """(Named when the port raised NotImplementedError for these names.) A
    lazy MuJoCo name resolves in both packages to a class of the same name,
    and ``make_env_from_name`` builds it through the envs-package fallback as
    the JAX package does; the pixel wrapper needs an environment to wrap, in
    both."""
    ours, ref = getattr(torch_envs, name), getattr(jax_envs, name)
    assert ours.__name__ == ref.__name__ and ours.__module__.startswith("mbrl_tpu_torch.envs.")
    jax_cfg, torch_cfg = _cfgs(name)
    if name == "MujocoGymPixelWrapper":
        for make, cfg in ((torch_env.make_env_from_name, torch_cfg),
                          (jax_env.make_env_from_name, jax_cfg)):
            with pytest.raises(TypeError):
                make(cfg, name)
        return
    env = torch_env.make_env_from_name(torch_cfg, name)
    assert isinstance(env, ours)
    assert env.observation_space.shape == ref().observation_space.shape
    env.close()


def test_an_unknown_name_raises_value_error_in_both():
    jax_cfg, torch_cfg = _cfgs("NoSuchEnv")
    with pytest.raises(ValueError):
        torch_env.make_env_from_name(torch_cfg, "NoSuchEnv")
    with pytest.raises(ValueError):
        jax_env.make_env_from_name(jax_cfg, "NoSuchEnv")
    assert not hasattr(torch_envs, "NoSuchEnv")


def test_a_pybullet_name_still_raises_not_implemented():
    _, torch_cfg = _cfgs("pybulletgym___InvertedPendulumPyBulletEnv-v0")
    with pytest.raises(NotImplementedError, match="pybullet"):
        torch_env.make_env_from_name(torch_cfg, "pybulletgym___InvertedPendulumPyBulletEnv-v0")


# --------------------------------------------------------------------------- #
# The MuJoCo environments, step for step
# --------------------------------------------------------------------------- #
ENV_CLASSES = ["PetsHalfCheetahEnv", "PetsCartPoleEnv", "AntTruncatedObsEnv",
               "HumanoidTruncatedObsEnv", "PetsPusherEnv", "PetsReacher3DEnv"]
# their reset noise: the JAX package draws it from numpy's global generator
# here, the port from the environment's seeded one
GLOBAL_RNG_RESET = ("PetsHalfCheetahEnv", "PetsCartPoleEnv")


def _sync(ours, ref, name):
    """The JAX environment put in the port's state after a reset."""
    ref.set_state(ours.data.qpos.copy(), ours.data.qvel.copy())
    if name == "PetsHalfCheetahEnv":
        ref.prev_qpos = ours.prev_qpos.copy()


def _step_both(ours, ref, steps=20, seed=1):
    rng = np.random.default_rng(seed)
    space = ours.action_space
    for _ in range(steps):
        action = rng.uniform(space.low, space.high).astype(space.dtype)
        got, want = ours.step(action), ref.step(action)
        np.testing.assert_array_equal(got[0], want[0])
        assert float(got[1]) == float(want[1])
        assert (bool(got[2]), bool(got[3])) == (bool(want[2]), bool(want[3]))


@pytest.mark.parametrize("name", ENV_CLASSES)
def test_mujoco_env_follows_the_jax_package_step_for_step(name):
    ours, ref = getattr(torch_envs, name)(), getattr(jax_envs, name)()
    for a, b in ((ours.observation_space, ref.observation_space),
                 (ours.action_space, ref.action_space)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    obs, _ = ours.reset(seed=0)
    ref_obs, _ = ref.reset(seed=0)
    if name in GLOBAL_RNG_RESET:
        again, _ = ours.reset(seed=0)
        np.testing.assert_array_equal(obs, again)  # reset(seed=...) fixes the port's noise
        _sync(ours, ref, name)
    else:
        np.testing.assert_array_equal(obs, ref_obs)
    _step_both(ours, ref)
    ours.close()
    ref.close()


def test_reacher_forward_kinematics_equal_the_jax_package():
    from mbrl_tpu.envs.pets_reacher import Reacher3DEnv as JaxReacher
    from mbrl_tpu_torch.envs.pets_reacher import Reacher3DEnv

    states = np.random.default_rng(0).uniform(-2, 2, (64, 7))
    np.testing.assert_array_equal(Reacher3DEnv.get_EE_pos(states), JaxReacher.get_EE_pos(states))


def test_model_side_functions_equal_the_jax_package():
    from mbrl_tpu.envs.pets_cartpole import CartPoleEnv as JaxCartPole
    from mbrl_tpu.envs.pets_halfcheetah import HalfCheetahEnv as JaxHalfCheetah
    from mbrl_tpu_torch.envs.pets_cartpole import CartPoleEnv
    from mbrl_tpu_torch.envs.pets_halfcheetah import HalfCheetahEnv

    x = np.random.default_rng(1).standard_normal((3, 5, 18))
    for ours, ref in ((HalfCheetahEnv, JaxHalfCheetah), (CartPoleEnv, JaxCartPole)):
        np.testing.assert_allclose(ours.preprocess_fn(torch.as_tensor(x)).numpy(),
                                   ref.preprocess_fn(x), atol=1e-12)
    act = np.random.default_rng(2).standard_normal((5, 6))
    np.testing.assert_array_equal(HalfCheetahEnv.get_reward(x[0], act), JaxHalfCheetah.get_reward(x[0], act))


def test_an_instance_is_of_the_named_class_and_pickles():
    import pickle

    from mbrl_tpu_torch.envs.pets_halfcheetah import HalfCheetahEnv

    env = HalfCheetahEnv()
    env.reset(seed=0)
    assert isinstance(env, HalfCheetahEnv) and type(env) is not HalfCheetahEnv
    assert type(HalfCheetahEnv()) is type(env)  # one subclass, made once
    back = pickle.loads(pickle.dumps(env))
    assert type(back) is type(env) and back.observation_space.shape == (18,)
    env.close()
    back.close()


# --------------------------------------------------------------------------- #
# The pixel wrapper
# --------------------------------------------------------------------------- #
def _pixel_pair(bit_depth):
    from mbrl_tpu.envs.mujoco_pixel_wrapper import MujocoGymPixelWrapper as JaxWrapper
    from mbrl_tpu.envs.pets_cartpole import CartPoleEnv as JaxCartPole
    from mbrl_tpu_torch.envs.mujoco_pixel_wrapper import MujocoGymPixelWrapper
    from mbrl_tpu_torch.envs.pets_cartpole import CartPoleEnv

    kw = dict(image_width=32, image_height=32, frame_skip=2, bit_depth=bit_depth)
    return (MujocoGymPixelWrapper(CartPoleEnv(render_mode="rgb_array"), **kw),
            JaxWrapper(JaxCartPole(render_mode="rgb_array"), **kw))


def test_pixel_wrapper_is_exact_at_bit_depth_8():
    ours, ref = _pixel_pair(8)
    assert ours.observation_space.shape == ref.observation_space.shape == (3, 32, 32)
    np.testing.assert_array_equal(ours.action_space.low, ref.action_space.low)
    # one reset noise for both: the JAX cartpole draws it from numpy's global
    # generator, the port's from its own, here a RandomState of the same seed.
    # (Frames of one state differ in a few texels when the two simulations
    # reached it by different histories, so the states are not synced after
    # the fact as in the test above.)
    ours.unwrapped.np_random = np.random.RandomState(0)
    np.random.seed(0)
    obs, _ = ours.reset()
    ref_obs, _ = ref.reset()
    assert obs.shape == (3, 32, 32) and obs.dtype == np.uint8
    np.testing.assert_array_equal(obs, ref_obs)
    rng = np.random.default_rng(3)
    for _ in range(20):
        action = rng.uniform(-1, 1, (1,)).astype(np.float32)
        got, want = ours.step(action), ref.step(action)
        np.testing.assert_array_equal(got[0], want[0])
        assert float(got[1]) == float(want[1])
        np.testing.assert_array_equal(ours.get_last_low_dim_obs(), ref.get_last_low_dim_obs())
    ours.close()
    ref.close()


def test_pixel_wrapper_dither_follows_its_seed():
    ours, _ = _pixel_pair(5)
    first, _ = ours.reset(seed=4)
    again, _ = ours.reset(seed=4)
    np.testing.assert_array_equal(first, again)
    other, _ = ours.reset(seed=5)
    assert (first % 8 != 0).any()  # dithered below the quantisation step
    assert not np.array_equal(first, other)
    ours.close()


# --------------------------------------------------------------------------- #
# Handlers (tests/test_envs.py:60-110)
# --------------------------------------------------------------------------- #
def _wrapped(env, how):
    if how == "bare":
        return env
    if how == "port_time_limit":
        return TimeLimit(env, max_episode_steps=50)
    import gymnasium

    return gymnasium.wrappers.TimeLimit(env, max_episode_steps=50)


@pytest.mark.parametrize("how", ["bare", "port_time_limit", "gym_time_limit"])
def test_mujoco_handler_freeze_and_state_round_trip(how):
    from mbrl_tpu_torch.envs.pets_halfcheetah import HalfCheetahEnv

    handler = torch_env.MujocoEnvHandler
    env = _wrapped(HalfCheetahEnv(), how)
    env.reset(seed=0)
    assert handler.is_correct_env_type(env)
    assert not handler.is_correct_env_type(TimeLimit(torch_envs.CartPoleEnv(), 50))
    env.step(env.action_space.sample())
    elapsed = getattr(env, "_elapsed_steps", None)
    before = handler.get_current_state(env)
    with handler.freeze(env):
        for _ in range(5):
            env.step(env.action_space.sample())
    after = handler.get_current_state(env)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    assert getattr(env, "_elapsed_steps", None) == elapsed
    # set_env_state puts back a state taken earlier
    env.step(env.action_space.sample())
    handler.set_env_state(before, env)
    np.testing.assert_array_equal(handler.get_current_state(env)[0], before[0])
    env.close()


def test_rollout_env_equals_the_jax_package():
    from mbrl_tpu.envs.pets_halfcheetah import HalfCheetahEnv as JaxHalfCheetah
    from mbrl_tpu_torch.envs.pets_halfcheetah import HalfCheetahEnv

    ours, ref = TimeLimit(HalfCheetahEnv(), 100), JaxHalfCheetah()
    obs, _ = ours.reset(seed=0)
    ref.reset(seed=0)
    _sync(ours.unwrapped, ref, "PetsHalfCheetahEnv")
    plan = np.random.default_rng(4).uniform(-1, 1, (8, 6))
    got = torch_env.MujocoEnvHandler.rollout_env(ours, obs, 0, plan=plan)
    want = jax_env.MujocoEnvHandler.rollout_env(ref, obs, 0, plan=plan)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (9, 18)
    # the environment is back where it started
    np.testing.assert_array_equal(torch_env.MujocoEnvHandler.get_current_state(ours)[0],
                                  jax_env.MujocoEnvHandler.get_current_state(ref)[0])
    assert ours._elapsed_steps == 0
    ours.close()
    ref.close()


def test_generic_handler_freezes_the_numpy_cartpole():
    handler = torch_env.GenericEnvHandler
    env = TimeLimit(torch_envs.CartPoleEnv(), 50)
    obs, _ = env.reset(seed=0)
    before = env.unwrapped.state.copy()
    real, rewards, actions = handler.rollout_env(env, obs, 6, plan=np.full((6, 1), 0.5, np.float32))
    assert real.shape == (7, 4) and rewards.shape == (6,) and actions.shape == (6, 1)
    assert not np.array_equal(real[-1], real[0])
    np.testing.assert_array_equal(env.unwrapped.state, before)


def test_dmcontrol_handler_freeze():
    from mbrl_tpu_torch.util.dmcontrol_wrapper import DmControlEnv

    assert isinstance(torch_env.create_handler_from_str("dmcontrol___cartpole--balance"),
                      torch_env.DmcontrolEnvHandler)
    env = DmControlEnv("cartpole", "balance", seed=0)
    env.reset()
    handler = torch_env.DmcontrolEnvHandler
    assert handler.is_correct_env_type(env)
    before = handler.get_current_state(env)
    with handler.freeze(env):
        for _ in range(5):
            env.step(env.action_space.sample())
    np.testing.assert_allclose(before[0], handler.get_current_state(env)[0])


@pytest.mark.parametrize("name", ["pets_halfcheetah", "cartpole_pets_version", "ant_truncated_obs",
                                  "gym___HalfCheetah-v5", "gym___Pendulum-v1", "cartpole_continuous",
                                  "dmcontrol___cheetah--run"])
def test_create_handler_from_str_picks_the_references_handler(name):
    ours = type(torch_env.create_handler_from_str(name)).__name__
    assert ours == type(jax_env.create_handler_from_str(name)).__name__


@pytest.mark.parametrize(
    "override,obs_dim,has_reward_fn",
    [
        ("pets_cartpole", 4, True),
        ("pets_halfcheetah", 18, True),
        ("pets_cartpole_paper_version", 4, True),
        ("mbpo_inv_pendulum", 4, False),
        ("mbpo_ant", 27, False),
    ],
)
def test_create_handler_makes_the_overrides_env(override, obs_dim, has_reward_fn):
    cfg = load_config(CONF, "main", overrides=[f"overrides={override}"])
    handler = torch_env.create_handler(cfg)
    jhandler = jax_env.create_handler(jax_load_config(JAX_CONF, "main", overrides=[f"overrides={override}"]))
    assert type(handler).__name__ == type(jhandler).__name__
    env, term_fn, reward_fn = handler.make_env(cfg)
    obs, _ = env.reset(seed=0)
    assert obs.shape == (obs_dim,)
    _, reward, *_ = env.step(env.action_space.sample())
    assert np.isfinite(reward)
    assert (reward_fn is not None) == has_reward_fn
    flags = term_fn(torch.zeros((3, env.action_space.shape[0])), torch.zeros((3, obs_dim)))
    assert flags.shape == (3, 1) and flags.dtype == torch.bool
    if cfg.overrides.get("trial_length", None):
        assert isinstance(env, TimeLimit) and env._max_episode_steps == cfg.overrides.trial_length
    env.close()
