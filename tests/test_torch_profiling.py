"""The port's profiling hooks (``mbrl_tpu_torch/util/profiling.py``) against
mbrl_tpu's, on the CPU: ``StepTimer``'s summary keys and counts and its
report's layout equal the JAX package's; ``trace`` writes a Chrome trace that
holds the ``annotate`` ranges of the traced region."""
import json

import jax.numpy as jnp
import numpy as np
import torch

from mbrl_tpu.util import profiling as jax_profiling
from mbrl_tpu_torch.util import profiling


def _drive(timer, block):
    for i in range(3):
        with timer.phase("plan", block=block(i)):
            pass
    with timer.phase("model_train"):
        pass


def test_step_timer_summary_matches_jax():
    timer, jtimer = profiling.StepTimer(), jax_profiling.StepTimer()
    _drive(timer, lambda i: {"x": torch.ones(2) * i, "y": [torch.zeros(1)]})
    _drive(jtimer, lambda i: {"x": jnp.ones(2) * i, "y": [jnp.zeros(1)]})
    summary, jsummary = timer.summary(), jtimer.summary()
    assert summary.keys() == jsummary.keys() == {"plan", "model_train"}
    for name in summary:
        assert summary[name].keys() == jsummary[name].keys()
        assert summary[name]["count"] == jsummary[name]["count"]
        assert all(np.isfinite(v) and v >= 0 for v in summary[name].values())
    report, jreport = timer.report().splitlines(), jtimer.report().splitlines()
    assert report[0] == jreport[0] and len(report) == len(jreport) == 3
    assert [r.split()[:2] for r in report[1:]] == [r.split()[:2] for r in jreport[1:]]
    timer.clear()
    assert timer.summary() == {}


def test_trace_writes_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("plan"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "plan" in names
    assert any("mm" in (n or "") for n in names)
    assert any(e.name == "plan" for e in prof.events())
