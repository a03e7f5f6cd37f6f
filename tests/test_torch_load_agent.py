"""``planning.load_agent``'s SAC branch (``mbrl_tpu_torch/planning/core.py``)
against mbrl_tpu's, on a run directory whose ``sac.pkl`` the JAX package
wrote, on the CPU (the PETS branch is in ``test_torch_diagnostics.py``).

Tolerances: deterministic actions 1e-5 absolute (a tanh over float32
products of width 32 in two libraries); the carried-across networks,
log-alpha, counter and Adam moments equal.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mbrl_tpu.config import load_config as jax_load_config
from mbrl_tpu.config import to_dict as jax_to_dict
from mbrl_tpu.planning import load_agent as jax_load_agent
from mbrl_tpu.util.env import create_handler as jax_create_handler
from mbrl_tpu_torch.diagnostics.common import load_run_config
from mbrl_tpu_torch.planning import SACAgent, load_agent
from mbrl_tpu_torch.util.env import make_env

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_CONF = REPO / "mbrl_tpu" / "examples" / "conf"
ACTION_ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_sac_run(tmp_path_factory):
    """config.yaml of mbpo_cartpole (SAC 32 wide) and a JAX sac.pkl after
    three updates (Adam moments and the counter live)."""
    out = tmp_path_factory.mktemp("jax_mbpo_run")
    cfg = jax_load_config(JAX_CONF, "main", overrides=["algorithm=mbpo", "overrides=mbpo_cartpole"])
    cfg.overrides["sac_hidden_size"] = 32
    with open(out / "config.yaml", "w") as f:
        yaml.safe_dump(jax_to_dict(cfg), f)
    env, _, _ = jax_create_handler(cfg).make_env(cfg)
    from mbrl_tpu.planning.sac import SAC as JaxSAC

    ov = cfg.overrides
    sac = JaxSAC(num_inputs=4, action_space=env.action_space, gamma=ov.sac_gamma, tau=ov.sac_tau,
                 alpha=ov.sac_alpha, policy=ov.sac_policy,
                 target_update_interval=ov.sac_target_update_interval,
                 automatic_entropy_tuning=ov.sac_automatic_entropy_tuning,
                 hidden_size=ov.sac_hidden_size, lr=ov.sac_lr,
                 target_entropy=ov.get("sac_target_entropy", None))
    state = sac.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    for i in range(3):
        batch = (rng.standard_normal((16, 4)), rng.uniform(-1, 1, (16, 1)),
                 rng.standard_normal((16, 4)), rng.standard_normal((16, 1)),
                 np.ones((16, 1)))
        state, _ = sac.update_parameters(state, tuple(jnp.asarray(b, jnp.float32) for b in batch),
                                         jax.random.PRNGKey(10 + i))
    sac.save_checkpoint(state, out / "sac.pkl")
    return out


def test_sac_from_a_jax_sac_pkl(jax_sac_run):
    cfg = load_run_config(jax_sac_run)
    env, _, _ = make_env(cfg)
    agent = load_agent(jax_sac_run, env, device="cpu")
    assert isinstance(agent, SACAgent)
    assert int(agent.state.updates) == 3
    jenv, _, _ = jax_create_handler(cfg).make_env(cfg)
    jagent = jax_load_agent(jax_sac_run, jenv)
    assert float(agent.state.log_alpha.detach()) == float(np.asarray(jagent.state.log_alpha))
    obs = np.random.default_rng(1).standard_normal((8, 4)).astype(np.float32)
    actions = agent.act(obs, sample=False)
    jactions = np.stack([np.asarray(jagent.act(o, sample=False)) for o in obs])
    assert actions.shape == (8, 1)
    np.testing.assert_allclose(actions, jactions, rtol=0, atol=ACTION_ATOL)
    # Adam's moments came across: the policy optimizer has a state per parameter
    assert all(agent.state.policy_opt.state[p]["exp_avg"].abs().sum() > 0
               for p in agent.state.policy.parameters())
    # cfg= replaces the file read
    again = load_agent(jax_sac_run, env, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(again.act(obs, sample=False), actions)


def test_sac_round_trip_of_a_port_sac_pkl(jax_sac_run, tmp_path):
    """A sac.pkl that the port wrote reloads into the same actions."""
    cfg = load_run_config(jax_sac_run)
    env, _, _ = make_env(cfg)
    agent = load_agent(jax_sac_run, env, device="cpu")
    (tmp_path / "config.yaml").write_text((jax_sac_run / "config.yaml").read_text())
    agent.sac.save_checkpoint(agent.state, tmp_path / "sac.pkl")
    again = load_agent(tmp_path, env, device="cpu")
    obs = np.random.default_rng(2).standard_normal((8, 4)).astype(np.float32)
    np.testing.assert_array_equal(again.act(obs, sample=False), agent.act(obs, sample=False))
    for p, q in zip(agent.state.critic.parameters(), again.state.critic.parameters()):
        assert torch.equal(p, q)


def test_unknown_algorithm_raises(jax_sac_run):
    cfg = load_run_config(jax_sac_run)
    cfg.algorithm["name"] = "planet"
    env, _, _ = make_env(cfg)
    with pytest.raises(ValueError, match="planet"):
        load_agent(jax_sac_run, env, cfg=cfg, device="cpu")
