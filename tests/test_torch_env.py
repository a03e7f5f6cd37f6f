"""``make_env_from_name`` of the port against the JAX package's, on the CPU.

Both resolve a name in one order: a custom name (``_CUSTOM_ENVS``) first,
then ``overrides.env_cfg``, then the prefixes, then an environment class
registered in the envs package. The port builds the environments it has
(the continuous cartpole) and raises ``NotImplementedError`` naming
``mujoco`` for the MuJoCo ones, before it reads ``env_cfg``; the JAX package,
which has MuJoCo here, builds them.
"""
import numpy as np
import pytest

import mbrl_tpu.envs as jax_envs
import mbrl_tpu_torch.config as torch_config
import mbrl_tpu_torch.envs as torch_envs
from mbrl_tpu.config import Config as JaxConfig
from mbrl_tpu.util import env as jax_env
from mbrl_tpu_torch.config import Config as TorchConfig
from mbrl_tpu_torch.util import env as torch_env


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
    with pytest.raises(NotImplementedError, match="mujoco"):
        torch_env.make_env_from_name(torch_cfg, name)
    pytest.importorskip("mujoco")
    env = jax_env.make_env_from_name(jax_cfg, name)
    want = getattr(jax_envs, jax_env._CUSTOM_ENVS[name])
    assert isinstance(env, want)
    assert not isinstance(env, jax_envs.CartPoleEnv)
    env.close()


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
    _, torch_cfg = _cfgs(name)
    with pytest.raises(NotImplementedError, match="mujoco"):
        torch_env.make_env_from_name(torch_cfg, name)
    with pytest.raises(NotImplementedError, match="mujoco"):
        getattr(torch_envs, name)
    # a name the JAX package resolves lazily
    pytest.importorskip("mujoco")
    assert getattr(jax_envs, name) is not None


def test_an_unknown_name_raises_value_error_in_both():
    jax_cfg, torch_cfg = _cfgs("NoSuchEnv")
    with pytest.raises(ValueError):
        torch_env.make_env_from_name(torch_cfg, "NoSuchEnv")
    with pytest.raises(ValueError):
        jax_env.make_env_from_name(jax_cfg, "NoSuchEnv")
    assert not hasattr(torch_envs, "NoSuchEnv")
