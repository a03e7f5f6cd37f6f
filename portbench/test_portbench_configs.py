"""Each configuration equal to the port's YAML tree, and its derived sizes."""
import json
import pathlib

import pytest
import yaml

from portbench import inputs

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONF = ROOT / "mbrl_tpu_torch" / "examples" / "conf"
CONFIGS = sorted(p.stem for p in (ROOT / "portbench" / "configs").glob("*.json"))


def _load(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_config_equals_the_yaml_tree(name):
    cfg = _load(name)
    for group, rel in cfg["yaml"].items():
        tree = yaml.safe_load((CONF / rel).read_text())
        # interpolations (${...}) and the sizes an environment fills in (???)
        # are derived, not copied
        want = {k: v for k, v in tree.items()
                if not (isinstance(v, str) and (v.startswith("${") or v == "???"))}
        assert cfg[group] == want, (name, group)
    assert cfg["source"].endswith(cfg["yaml"]["overrides"])


SIZES = {
    # obs, act, model in, model out, policy width, start states, horizon, ring rows
    ("mbpo_halfcheetah", "rollout_l1"): (17, 6, 23, 18, 512, 100_000, 1, 400_000),
    ("mbpo_walker", "rollout_l1"): (17, 6, 23, 18, 1024, 100_000, 1, 400_000),
    ("mbpo_humanoid", "rollout_l25"): (45, 17, 62, 46, 1024, 100_000, 25, 50_000_000),
}


@pytest.mark.parametrize("key", sorted(SIZES))
def test_derived_sizes(key):
    name, mix = key
    cfg = _load(name)
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{mix}.json").read_text())
    sz = inputs.sizes(cfg, traffic)
    assert (sz.obs, sz.act, sz.model_in, sz.model_out, sz.policy_hidden, sz.start_states,
            sz.horizon, sz.capacity) == SIZES[key]
    ov = cfg["overrides"]
    assert sz.start_states == ov["effective_model_rollouts_per_step"] * ov["freq_train_model"]
    assert sz.horizon == ov["rollout_schedule"][-1]
    assert (sz.members, sz.elites, sz.hid, sz.layers) == (7, 5, 200, 4)


def test_humanoid_ring_is_real_memory():
    sz = inputs.sizes(_load("mbpo_humanoid"),
                      json.loads((ROOT / "portbench/traffic/rollout_l25.json").read_text()))
    row_bytes = 4 * (sz.obs + sz.act + sz.obs + 1 + 1)
    assert row_bytes == 436
    assert (sz.capacity + 1) * row_bytes > 21.8e9


def test_the_benchmark_makes_the_same_inputs_from_the_same_seed():
    cfg = _load("mbpo_humanoid")
    traffic = json.loads((ROOT / "portbench/traffic/rollout_l25.json").read_text())
    sz = inputs.sizes(cfg, traffic, {"start_states": 50, "real_rows": 400, "capacity": 1000})
    a, b = (inputs.make(cfg, sz, 2**33 + 1, "cpu") for _ in range(2))
    c = inputs.make(cfg, sz, 2**33 + 2, "cpu")
    for x, y, z in zip(a.layer_w + a.policy_w + [a.real_obs],
                       b.layer_w + b.policy_w + [b.real_obs], c.layer_w + c.policy_w + [c.real_obs]):
        assert x.equal(y) and not x.equal(z)
    assert a.elite.unique().numel() == 5
    assert ((a.real_obs[:, 0] >= 1.1) & (a.real_obs[:, 0] <= 1.9)).all()
    assert a.layer_b[-1][..., sz.model_out:].eq(-6.0).all()
