"""``PIDAgent`` of the port against mbrl_tpu's: the same actions, errors and
parameters on the same observation sequences, exactly (float64 numpy in both)."""
import numpy as np
import pytest

from mbrl_tpu.planning import PIDAgent as JaxPIDAgent
from mbrl_tpu_torch.planning import PIDAgent


def _agents(**kw):
    return PIDAgent(**kw), JaxPIDAgent(**kw)


CASES = {
    "one_dof": dict(k_p=[1.0], k_i=[0.1], k_d=[0.5], target=[0.0], state_mapping=[0]),
    "mapped": dict(k_p=[1.0, 0.3], k_i=[0.05, 0.2], k_d=[0.5, 0.1], target=[0.2, -0.4],
                   state_mapping=[3, 1]),
    "batched": dict(k_p=[0.7, 1.2, 0.4], k_i=[0.1, 0.0, 0.3], k_d=[0.2, 0.6, 0.0],
                    target=[1.0, 0.0, -1.0], batch_dim=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pid_agent_equals_the_jax_one(case):
    ours, ref = _agents(**CASES[case])
    rng = np.random.default_rng(0)
    n_obs = 5 if case == "mapped" else ours.n_dof
    for step in range(30):
        obs = rng.standard_normal((n_obs, ours.batch_dim)) if ours.batch_dim > 1 else \
            rng.standard_normal(n_obs)
        got, want = ours.act(obs), ref.act(obs)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        for a, b in zip(ours.get_errors(), ref.get_errors()):
            np.testing.assert_array_equal(a, b)
        if step == 14:
            ours.reset()
            ref.reset()
    np.testing.assert_array_equal(ours.get_parameters(), ref.get_parameters())


def test_pid_agent_drives_a_first_order_system():
    """tests/test_diagnostics.py's case: x' = x + 0.5 a."""
    agent = PIDAgent(k_p=np.array([1.0]), k_i=np.array([0.1]), k_d=np.array([0.5]),
                     target=np.array([0.0]), state_mapping=np.array([0]))
    x = np.array([1.0, 0.0])
    for _ in range(40):
        a = agent.act(x)
        x[0] = x[0] + 0.5 * float(np.clip(a[0, 0], -1, 1))
    assert abs(x[0]) < 0.1, x[0]
    assert agent.get_errors()[0].shape == (1, 1)
    agent.reset()
    assert np.all(agent.get_errors()[1] == 0)
    assert agent.get_parameters().shape == (4,)


def test_pid_agent_refuses_mismatched_lengths():
    with pytest.raises(ValueError, match="share a length"):
        PIDAgent([1.0, 2.0], [0.1], [0.5], [0.0])
    with pytest.raises(ValueError, match="state_mapping"):
        PIDAgent([1.0], [0.1], [0.5], [0.0], state_mapping=[0, 1])
