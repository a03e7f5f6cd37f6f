"""The program's spans as the benchmark reads them: every target of the
``spans/*_program.json`` files resolves to the port's own function, and to a
stand-in on a port that lacks it; each reader of a program span returns its
number from made-up events put through ``tracing.reduce``, and nothing where
its span is absent; ``policy_roofline`` against a hand count."""
import importlib
import itertools
import json
import pathlib
import types

import pytest

from portbench import harness, program_boundaries, tracing, yardstick as Y

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
PROGRAM_SPANS = sorted((BENCH / "spans").glob("*_program.json"))
READERS = {name: harness.load_module(BENCH / "metrics" / f"{name}.py")
           for name in ("rollout_start_ms.rollout", "policy_roofline", "normalize_ms.rollout",
                        "model_shuffle_ms.rollout")}


def _resolve(target):
    module_name, attr = target.split(":")
    owner = importlib.import_module(module_name)
    *path, leaf = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, leaf


def test_every_program_span_target_resolves_to_the_ports_own_function():
    from mbrl_tpu_torch.algorithms import mbpo
    from mbrl_tpu_torch.models import GaussianMLP, TransitionRewardModel
    from mbrl_tpu_torch.planning.sac import GaussianPolicy

    want = {"start_rollout": mbpo.start_rollout,
            "GaussianPolicy.forward": GaussianPolicy.forward,
            "TransitionRewardModel._model_input": TransitionRewardModel._model_input,
            "GaussianMLP._permute_rows": GaussianMLP._permute_rows,
            "GaussianMLP._unpermute_rows": GaussianMLP._unpermute_rows}
    specs = [s for path in PROGRAM_SPANS for s in json.loads(path.read_text())["spans"]]
    assert sorted(s["name"] for s in specs) == sorted(want)
    layers = {json.loads(path.read_text())["layer"] for path in PROGRAM_SPANS}
    assert layers == {"rollout", "learner", "model env"}
    for spec in specs:
        owner, leaf = _resolve(spec["target"])
        assert getattr(owner, leaf) is want[spec["name"]], spec


def test_on_a_port_without_the_boundaries_the_wrapping_succeeds(monkeypatch):
    """A checkout of the port from before ``start_rollout`` and the two row
    moves: the wrappers go onto stand-ins, and the program is left as it was."""
    from mbrl_tpu_torch.algorithms import mbpo
    from mbrl_tpu_torch.models import GaussianMLP

    monkeypatch.delattr(mbpo, "start_rollout")
    monkeypatch.delattr(GaussianMLP, "_permute_rows")
    monkeypatch.delattr(GaussianMLP, "_unpermute_rows")
    try:
        stand_ins = importlib.reload(program_boundaries)
        assert stand_ins.mbpo is not mbpo and stand_ins.GaussianMLP is not GaussianMLP
        with pytest.raises(RuntimeError):
            stand_ins.mbpo.start_rollout()
        spans = tracing.Spans(BENCH)
        spans.install()
        spans.uninstall()
        assert not hasattr(mbpo, "start_rollout") and not hasattr(GaussianMLP, "_permute_rows")
    finally:
        monkeypatch.undo()
        importlib.reload(program_boundaries)
    assert program_boundaries.mbpo is mbpo and program_boundaries.GaussianMLP is GaussianMLP


class _E:
    """A raw profiler event (``tracing.reduce``'s interface)."""

    def __init__(self, kind, name, s, e, corr=0):
        self._v = (kind, name, s, e, corr)

    def activity_type(self):
        return self._v[0]

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return 1

    def linked_correlation_id(self):
        return 0


_CORRELATION = itertools.count(1)


def _span(name, s, e, launches):
    """A span from ``s`` to ``e`` ns, and for each ``(start, end)`` of
    ``launches`` a launch inside it and its kernel on the device."""
    out = [_E("user_annotation", name, s, e)]
    for k, (k0, k1) in enumerate(launches):
        corr = next(_CORRELATION)
        out += [_E("cuda_runtime", "cudaLaunchKernel", s + k + 1, s + k + 2, corr),
                _E("kernel", f"{name}_kernel_{k}", k0, k1, corr)]
    return out


SZ = types.SimpleNamespace(obs=17, act=6, policy_hidden=1024)
POLICY_ARGS = ([object(), ("tensor", (100_000, 17), 4)], {})


def _trace(with_program_spans):
    """Two steps of a rollout, in ns: the start, then per step the policy and
    the model's input, permutation and un-permutation."""
    events = [_E("user_annotation", tracing.WINDOW_SPAN, 0, 10_000)]
    calls, args = {}, {}
    if with_program_spans:
        events += _span("start_rollout", 10, 100, [(100, 400)])
        calls["start_rollout"] = 1
        for step in range(2):
            t = 1_000 + 4_000 * step
            events += _span("GaussianPolicy.forward", t, t + 100, [(t + 100, t + 2_100)])
            events += _span("TransitionRewardModel._model_input", t + 200, t + 300,
                            [(t + 2_100, t + 2_150), (t + 2_150, t + 2_180)])
            events += _span("GaussianMLP._permute_rows", t + 400, t + 500, [(t + 2_200, t + 2_240)])
            events += _span("GaussianMLP._unpermute_rows", t + 600, t + 700,
                            [(t + 2_300, t + 2_320), (t + 2_320, t + 2_330)])
        calls.update({"GaussianPolicy.forward": 2, "TransitionRewardModel._model_input": 2,
                      "GaussianMLP._permute_rows": 2, "GaussianMLP._unpermute_rows": 2})
        args["GaussianPolicy.forward"] = [POLICY_ARGS, POLICY_ARGS]
    else:  # only the spans the benchmark had before
        events += _span("SAC.act_tensor", 1_000, 1_100, [(1_100, 3_100)])
        calls["SAC.act_tensor"] = 1
    names = list(calls) + ["SAC.act_tensor"]
    spans = types.SimpleNamespace(calls=calls, args=args, names=names)
    return tracing.reduce(events, 1e-5, spans)


def _run(trace):
    return harness.Run(cell=types.SimpleNamespace(sz=SZ), setup_s=1.0, window_s=1e-5,
                       rollouts=1, rows=100_000, trace=trace)


def test_each_reader_reads_its_program_span():
    run = _run(_trace(True))
    assert READERS["rollout_start_ms.rollout"].read(run) == pytest.approx(300e-6)
    # a step: 50 + 30 ns of the model's input, 40 + 20 + 10 ns of the shuffle
    assert READERS["normalize_ms.rollout"].read(run) == pytest.approx(80e-6)
    assert READERS["model_shuffle_ms.rollout"].read(run) == pytest.approx(70e-6)
    least_ms = 2 * Y.bound(*READERS["policy_roofline"].flops_bytes(100_000, 17, 1024, 6),
                           False)[0]
    assert READERS["policy_roofline"].read(run) == pytest.approx(100 * least_ms / 4e-3)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_nothing_without_its_span(name):
    assert READERS[name].read(_run(_trace(False))) is None
    assert READERS[name].read(_run(None)) is None


def test_policy_roofline_by_hand():
    # Walker2d's policy at 100,000 rows: 17x1024 + 1024x1024 + 1024x12 multiply-adds a row
    flops, nbytes = READERS["policy_roofline"].flops_bytes(100_000, 17, 1024, 6)
    assert flops == 2 * 100_000 * (17_408 + 1_048_576 + 12_288) == 215_654_400_000
    assert nbytes == 4 * (100_000 * (17 + 12) + 1_078_272 + (1024 + 1024 + 12))
    ms, by = Y.bound(flops, nbytes, False)
    assert by == "operations" and ms == pytest.approx(3 * 215_654_400_000 / 495e12 * 1e3)
    assert round(ms, 3) == 1.307
    # one call read over 5.2 ms of its span's device time: 25.1%
    trace = types.SimpleNamespace(span_device_s={"GaussianPolicy.forward": 5.2e-3},
                                  span_args={"GaussianPolicy.forward": [POLICY_ARGS]})
    assert READERS["policy_roofline"].read(_run(trace)) == pytest.approx(100 * ms / 5.2)
