"""The port's ``PlanetVisualizer`` (``mbrl_tpu_torch/diagnostics/planet_visualizer.py``)
on a ``planet.pkl`` that the JAX package wrote (tests/test_planet.py:309-346's
recipe), on the CPU.

Tolerances: the decoder's output for the same latents and beliefs 1e-5 of its
largest magnitude (float32 deconvolutions in two libraries); the uint8 frames
``render`` makes from it within one level (a float that straddles a level
rounds either way); the replay's shapes exact.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mbrl_tpu.models import PlaNetModel as JaxPlaNet
from mbrl_tpu_torch.diagnostics import PlanetVisualizer
from test_torch_planet import BELIEF, DEC_CFG, ENC_CFG, LATENT, OBS_SHAPE, SMALL, MockPixelEnv

DECODE_RTOL = 1e-5


@pytest.fixture
def jax_planet_run(tmp_path):
    model = JaxPlaNet(**SMALL)
    model.save(model.init(jax.random.PRNGKey(0)), tmp_path)
    cfg = {
        "seed": 0,
        "dynamics_model": {
            "_target_": "mbrl_tpu.models.PlaNetModel",
            "obs_shape": list(OBS_SHAPE),
            "obs_encoding_size": 64,
            "encoder_config": [list(c) for c in ENC_CFG],
            "decoder_config": [list(DEC_CFG[0]), [list(c) for c in DEC_CFG[1]]],
            "latent_state_size": LATENT,
            "belief_size": BELIEF,
            "hidden_size_fcs": 32,
        },
        "overrides": {"env": "mock"},
    }
    with open(tmp_path / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return tmp_path


def test_replay_renders_as_the_jax_model_does(jax_planet_run, monkeypatch):
    vis = PlanetVisualizer(start_step=1, lookahead=3, model_dir=str(jax_planet_run), seed=0,
                           num_iterations=2, population_size=20, planning_horizon=3,
                           env=MockPixelEnv(), device="cpu")
    assert type(vis.planet).__module__ == "mbrl_tpu_torch.models.planet"
    result = vis.compute()
    n = len(result["actions"])
    assert n == 3 and len(result["true_obs"]) == 3
    assert result["latents"].shape == (n + 1, LATENT) and result["beliefs"].shape == (n + 1, BELIEF)
    assert result["pred_imgs"].shape == (n + 1, 32, 32, 3) and result["pred_imgs"].dtype == np.uint8
    assert np.isfinite(result["pred_total_reward"]) and np.isfinite(result["true_total_reward"])
    assert all(np.all(np.abs(a) <= 1.0) for a in result["actions"])

    jmodel = JaxPlaNet(**SMALL)
    jstate = jmodel.load(jmodel.init(jax.random.PRNGKey(1)), jax_planet_run)
    latents, beliefs = result["latents"].numpy(), result["beliefs"].numpy()
    jdecoded = np.asarray(jmodel._decode(jstate["params"], jnp.asarray(latents),
                                         jnp.asarray(beliefs)))
    with torch.no_grad():
        decoded = vis.planet._decode(vis.planet_state["params"], result["latents"],
                                     result["beliefs"]).numpy()
    np.testing.assert_allclose(decoded, jdecoded, rtol=0,
                               atol=DECODE_RTOL * float(np.abs(jdecoded).max()))
    jframes = jmodel.render(jstate, jnp.asarray(latents), jnp.asarray(beliefs))
    assert np.abs(result["pred_imgs"].astype(int) - jframes.astype(int)).max() <= 1

    # the artifact: a GIF, or the frames as .npz when imageio is missing
    out = vis.write(result["true_obs"], result["pred_imgs"])
    assert out.exists() and out.parent == jax_planet_run / "diagnostics"
    monkeypatch.setitem(sys.modules, "imageio", None)
    out = vis.run()
    assert out.name == "visualization_1_3_0.gif.npz"
    frames = np.load(out)["frames"]
    assert frames.shape == (3, 32, 64, 3)  # pred | true, side by side
