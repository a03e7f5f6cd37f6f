"""The port's spans along MBPO's imagined rollout (``util/profiling.py``'s
``annotate`` and ``span``), on the CPU's plain kernel paths at a toy size:

- a trace of a rollout (TS1 over an ensemble of 3, horizon 2) holds the ten
  spans, each nested in its caller's;
- with no profiler recording, no span makes a ``RecordFunction``;
- the rollout's rows are bit-equal to those of the code before the spans
  and the moves (``start_rollout``, ``GaussianMLP._permute_rows`` and
  ``_unpermute_rows``), inlined here;
- K3's launches by route (``kernels.launch_counts``), on the card only.
"""
import pytest
import torch

import mbrl_tpu_torch.algorithms.mbpo as mbpo
from mbrl_tpu_torch.envs.spaces import Box
from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel
from mbrl_tpu_torch.ops import kernels
from mbrl_tpu_torch.planning.sac import SAC
from mbrl_tpu_torch.util import profiling
from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer

OBS, ACT, E, HID = 3, 2, 3, 16
ROWS, HORIZON, CAPACITY = 12, 2, 64
KILL = 0.2  # a row dies when its next obs[0] passes this

# each span and the span of its caller
PARENT = {
    "start_rollout": "imagined_rollout",
    "SAC.act_tensor": "imagined_rollout",
    "GaussianPolicy.forward": "SAC.act_tensor",
    "ModelEnv.step": "imagined_rollout",
    "TransitionRewardModel._model_input": "ModelEnv.step",
    "GaussianMLP._permute_rows": "ModelEnv.step",
    "fused_ensemble_mlp": "ModelEnv.step",
    "GaussianMLP._unpermute_rows": "ModelEnv.step",
    "DeviceReplayBuffer.add_batch_masked": "imagined_rollout",
}
CALLS = {"imagined_rollout": 1, "start_rollout": 1, **{
    name: HORIZON for name in PARENT if name != "start_rollout"}}


def _term(act, next_obs):
    return (next_obs[:, 0] > KILL)[:, None]


def _toy():
    """A rollout's inputs: the model (float64 normaliser, learned rewards),
    the policy, a buffer with rows in it, and start states."""
    g = torch.Generator().manual_seed(0)
    model = GaussianMLP(OBS + ACT, OBS + 1, num_layers=2, ensemble_size=E, hid_size=HID,
                        activation="silu", propagation_method="random_model", device="cpu")
    wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=True,
                                    normalize_double_precision=True, learned_rewards=True)
    state = wrapper.init(g)
    batch = type("Batch", (), {"obs": torch.randn((50, OBS), generator=g),
                               "act": torch.randn((50, ACT), generator=g)})
    state = wrapper.update_normalizer(state, batch)
    sac = SAC(OBS, Box(-torch.ones(ACT).numpy(), torch.ones(ACT).numpy()), hidden_size=HID,
              device="cpu")
    policy = sac.init(g).policy
    buf = DeviceReplayBuffer(CAPACITY, OBS, ACT, device="cpu")
    pre = (torch.randn((30, OBS), generator=g), torch.randn((30, ACT), generator=g),
           torch.randn((30, OBS), generator=g), torch.randn(30, generator=g), torch.ones(30))
    obs0 = 0.3 * torch.randn((ROWS, OBS), generator=g)
    return ModelEnv(wrapper, _term, None), state, sac, policy, buf, pre, obs0


def _rollout(run=mbpo.imagined_rollout, samples=True):
    """The toy rollout through ``run``, the policy sampling its action or
    acting with its mean; the buffer's state after it."""
    model_env, state, sac, policy, buf, pre, obs0 = _toy()
    return run(model_env, state, sac, policy, buf, buf.add_batch(buf.init(), *pre), obs0,
               torch.Generator().manual_seed(4), HORIZON, samples)


def _unrefactored_rollout(model_env, model_state, sac, policy, sac_buffer, buf_state,
                          initial_obs, generator, horizon, sac_samples_action):
    """``mbpo.imagined_rollout`` as it was before the spans and
    ``start_rollout``."""
    batch = initial_obs.shape[0]
    with torch.no_grad():
        ms = model_env.reset(model_state, initial_obs, generator)
        prepare = getattr(model_env.dynamics_model, "prepare_rollout", None)
        if prepare is not None:
            ms = prepare(model_state, ms, horizon, generator)
        ms = model_env.shard(ms)
        obs = initial_obs
        alive = torch.ones((batch,), dtype=torch.bool, device=initial_obs.device)
        for _ in range(horizon):
            action = sac.act_tensor(policy, obs, generator, sample=sac_samples_action)
            next_obs, rewards, terminated, ms = model_env.step(
                model_state, action, ms, generator, sample=True
            )
            terminated = terminated.reshape(batch)
            buf_state = sac_buffer.add_batch_masked(
                buf_state, obs, action, next_obs, rewards.reshape(batch),
                1.0 - terminated.float(), valid=alive,
            )
            alive = alive & ~terminated
            obs = next_obs
    return buf_state


def _unrefactored_forward_sharded(self, params, x, perm, inv=None):
    """``GaussianMLP._forward_sharded`` as it was before the moves."""
    cached = self.packed(params)
    p = cached.view
    num_used = p["head"]["w"].shape[0]
    batch = x.shape[0]
    h = x[perm].reshape(num_used, batch // num_used, x.shape[-1]).float().contiguous()
    raw = kernels.fused_ensemble_mlp(h, cached.stack, tiles=cached.tiles)
    mean, logvar = self._bound(p, raw)
    mean = mean.reshape(batch, -1)
    if logvar is not None:
        logvar = logvar.reshape(batch, -1)
    if inv is None:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(batch, dtype=perm.dtype, device=perm.device)
    return mean[inv], None if logvar is None else logvar[inv]


def _rows(buf_state):
    return [t.clone() for t in buf_state.arrays()] + [buf_state.cur_idx.clone(),
                                                      buf_state.num_stored.clone()]


def test_a_traced_rollout_holds_the_ten_spans_each_in_its_callers(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        _rollout()
    events = [e for e in prof.events() if e.name in CALLS]
    assert {name: sum(e.name == name for e in events) for name in CALLS} == CALLS
    for e in events:
        if e.name in PARENT:
            assert any(p.name == PARENT[e.name] and p.thread == e.thread
                       and p.time_range.start <= e.time_range.start
                       and e.time_range.end <= p.time_range.end for p in events), e.name
    assert list(tmp_path.glob("trace_*.json"))


def test_without_a_profiler_no_span_makes_a_record_function(monkeypatch):
    want = _rows(_rollout())

    def refuse(name, args=None):
        raise AssertionError(f"a RecordFunction for {name!r} with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert all(torch.equal(a, b) for a, b in zip(_rows(_rollout()), want))
    assert profiling.annotate("a") is profiling.annotate("b")


def test_annotate_records_while_a_profiler_records():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        span = profiling.annotate("recorded")
        assert isinstance(span, torch.profiler.record_function)
        with span:
            torch.ones(4).sum()
    assert [e.name for e in prof.events()].count("recorded") == 1


def test_span_keeps_the_function_it_decorates():
    @profiling.span("named")
    def f(a, b=2):
        """f's docstring"""
        return a + b

    assert f(1) == 3 and f(1, b=5) == 6
    assert f.__name__ == "f" and f.__doc__ == "f's docstring"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        f(1)
    assert [e.name for e in prof.events()].count("named") == 1


@pytest.mark.parametrize("samples", [True, False], ids=["sampled", "mean"])
def test_the_rollout_rows_equal_the_unrefactored_code(monkeypatch, samples):
    got = _rows(_rollout(samples=samples))
    monkeypatch.setattr(GaussianMLP, "_forward_sharded", _unrefactored_forward_sharded)
    want = _rows(_rollout(_unrefactored_rollout, samples))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # rows died: fewer than every row of every step written
    written = (int(got[-2]) - 30) % CAPACITY
    assert ROWS <= written < ROWS * HORIZON, written


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"


@pytest.mark.card
def test_k3_counts_its_launches_by_route(card):
    """One K3 call on each route: the chain's cluster (one row per member),
    one tile a block (one wave), two tiles a block (past it), and the wide
    route's resident activations (512 wide) and scratch (1,024 wide)."""
    g = torch.Generator().manual_seed(0)
    calls = [("cluster", 200, 1), ("tile", 200, 64), ("pair", 200, 20_000),
             ("smem", 512, 64), ("scratch", 1024, 64)]
    for route, hid, rows in calls:
        model = GaussianMLP(23, 18, num_layers=4, ensemble_size=5, hid_size=hid,
                            activation="silu", propagation_method="random_model", device=card)
        params = model.init(torch.Generator(device=card).manual_seed(1))
        cached = model.packed(params)
        x = torch.randn((5, rows, 23), generator=g).to(card)
        kernels.reset_launch_counts()
        out = kernels.fused_ensemble_mlp(x, cached.stack, tiles=cached.tiles)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["fused_ensemble_mlp"] == 1 and torch.isfinite(out).all(), route
        assert {r: counts[f"fused_ensemble_mlp.{r}"]
                for r in kernels.K3_ROUTES + kernels.K3_WIDE_ROUTES} == {
            r: int(r == route) for r in kernels.K3_ROUTES + kernels.K3_WIDE_ROUTES}
