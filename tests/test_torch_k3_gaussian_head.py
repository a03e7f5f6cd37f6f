"""K3 in the batch's order with the Gaussian head finished in its epilogue
(``kernels.fused_ensemble_mlp``'s ``perm``, ``logvar_bounds`` and ``noise``;
``csrc/ensemble_mlp.cu``: ``mbrl_ensemble_mlp_head``), which
``GaussianMLP._forward_sharded`` and ``sample_1d`` take on the card where
``kernels.k3_fuses_head`` says so.

On the CPU, through the plain version, at MBPO-Walker's (23 -> 4x200 -> 36)
and MBPO-Humanoid's (62 -> 4x200 -> 92) widths with 5 elites of 7:

- the fused head is bit-equal to the composition it replaces: the TS1 gather
  (``_permute_rows``), the raw K3, ``_bound``, the reshape, the inverse
  gather (``_unpermute_rows``) and ``sample_1d``'s draw;
- ``sample_1d`` on the fused head gives the rows and leaves the generator as
  the code before it did (its normals drawn before the launch, not after);
- the dispatch rule, a pure function: two tiles a block takes the fused head;
  one tile a block, the cluster, the wide route, a deterministic head and the
  CPU do not;
- the wrapper hands the entry its arguments, against a stand-in library.

On the card (``-m card``; ``--noconftest``: ``tests/conftest.py`` imports
JAX): the kernel against its plain version at 100,000 and 100,005 rows (a
ragged last tile), with and without noise, and the launch counters over an
imagined rollout and a PETS-sized step.
"""
import pytest
import torch

import mbrl_tpu_torch.algorithms.mbpo as mbpo
from mbrl_tpu_torch.device import randn
from mbrl_tpu_torch.envs.spaces import Box
from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel
from mbrl_tpu_torch.ops import kernels
from mbrl_tpu_torch.planning.sac import SAC
from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer

NUM_SMS = 132  # an H100's
MEMBERS, ELITES = 7, 5
WIDTHS = {"walker": (23, 18), "humanoid": (62, 46)}  # model in, out (obs + reward)
REL = 1e-6  # the card's kernel against its plain version, |a - b| / max(1, |b|)


def _model(name, device="cpu", deterministic=False, hid=200, seed=0, dtype=torch.float32):
    din, out = WIDTHS[name]
    model = GaussianMLP(din, out, num_layers=4, ensemble_size=MEMBERS, hid_size=hid,
                        activation="silu", propagation_method="random_model",
                        deterministic=deterministic, compute_dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    params = model.init(g)
    for layer in params["layers"] + [params["head"]]:  # biases as a trained model's
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=g, device=device)
    if not deterministic:
        # raw log-variances from below the lower soft bound to above the upper
        params["head"]["b"][..., out:] += torch.linspace(-6.0, 3.0, out, device=device)
        params["min_logvar"] = torch.full((1, out), -3.0, device=device)
        params["max_logvar"] = torch.full((1, out), 0.25, device=device)
    return model, model.set_elite(params, [0, 2, 3, 5, 6])


def _glue(model, params, x, perm, noise):
    """The composition the fused head replaces, as it was: gather, raw K3,
    bound, reshape, inverse gather, then the draw."""
    cached = model.packed(params)
    batch = x.shape[0]
    h = model._permute_rows(x, perm, ELITES)
    raw = kernels.fused_ensemble_mlp(h, cached.stack, tiles=cached.tiles)
    mean, logvar = model._bound(cached.view, raw)
    mean, logvar = model._unpermute_rows(mean.reshape(batch, -1), logvar.reshape(batch, -1),
                                         perm, None)
    if noise is None:
        return mean, logvar
    return mean + torch.exp(0.5 * logvar) * noise, None


def _head(model, params, x, perm, noise):
    cached = model.packed(params)
    return kernels.fused_ensemble_mlp(
        x.reshape(ELITES, -1, x.shape[-1]), cached.stack, tiles=cached.tiles, perm=perm,
        logvar_bounds=(cached.view["max_logvar"], cached.view["min_logvar"]), noise=noise)


def _inputs(name, rows, device="cpu", seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, WIDTHS[name][0]), generator=g, device=device)
    perm = torch.randperm(rows, generator=g, device=device)
    noise = torch.randn((rows, WIDTHS[name][1]), generator=g, device=device)
    return x, perm, noise


@pytest.mark.parametrize("sample", [True, False], ids=["drawn", "mean"])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_the_plain_fused_head_is_bit_equal_to_the_glue(name, sample):
    model, params = _model(name)
    x, perm, noise = _inputs(name, ELITES * 40)
    noise = noise if sample else None
    got, want = _head(model, params, x, perm, noise), _glue(model, params, x, perm, noise)
    assert torch.equal(got[0], want[0])
    if sample:
        assert got[1] is None and want[1] is None
    else:
        assert torch.equal(got[1], want[1])
        lo, hi = params["min_logvar"][0, 0].item(), params["max_logvar"][0, 0].item()
        assert (got[1] < lo + 0.5).any() and (got[1] > hi - 0.5).any()  # both bounds at work


def _todays_sample_1d(model, params, x, model_state, g):
    """``sample_1d`` as it was: the propagated forward, then its draw."""
    precomputed = None
    if "rollout_perms" in model_state:
        precomputed = (model_state["rollout_perms"][0], model_state["rollout_invs"][0])
    mean, logvar = model.forward_propagated(
        params, x, generator=g, propagation_indices=model_state["propagation_indices"],
        precomputed=precomputed)
    return mean + torch.exp(0.5 * logvar) * randn(g, mean.shape, mean.device)


@pytest.mark.parametrize("case", ["precomputed", "drawn_perm", "fixed_model"])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_sample_1d_on_the_fused_head_keeps_the_rows_and_the_generator(monkeypatch, name, case):
    model, params = _model(name)
    if case == "fixed_model":
        model.propagation_method = "fixed_model"
    rows = ELITES * 40
    x, _, _ = _inputs(name, rows)

    def step():
        g = torch.Generator().manual_seed(7)
        ms = model.reset_1d(torch.zeros((rows, 1)), g)
        if case == "precomputed":
            ms = model.prepare_rollout(params, ms, 1, g)
        return g, ms

    g, ms = step()
    want = _todays_sample_1d(model, params, x, ms, g)
    want_state = g.get_state()
    monkeypatch.setattr(GaussianMLP, "_fuses_head", lambda self, cached, x, num_used: True)
    calls = []
    orig = kernels.fused_ensemble_mlp
    monkeypatch.setattr(kernels, "fused_ensemble_mlp", lambda *a, **k: calls.append(k) or orig(*a, **k))
    g, ms = step()
    got, _ = model.sample_1d(params, x, ms, g)
    assert len(calls) == 1 and calls[0]["noise"] is not None
    assert torch.equal(got, want)
    assert torch.equal(g.get_state(), want_state)


def _layout(dims, low_precision=False):
    wide = not kernels.takes_chain(dims, low_precision)
    return (kernels.WideTileLayout if wide else kernels.ChainLayout)(tuple(dims), low_precision)


WALKER = (23, 200, 200, 200, 200, 36)
HUMANOID = (62, 200, 200, 200, 200, 92)


@pytest.mark.parametrize("dims,low,rows,num_sms,gaussian,fused", [
    (WALKER, False, 20_000, NUM_SMS, True, True),        # the benchmark's rollouts: two tiles
    (HUMANOID, False, 20_000, NUM_SMS, True, True),
    (WALKER, True, 20_000, NUM_SMS, True, True),         # bf16 on the same route
    (WALKER, False, 16_000, NUM_SMS, True, True),        # mbpo.train's rollout at M
    (WALKER, False, 1_600, NUM_SMS, True, False),        # PETS's 8,000 rows: one tile a block
    (WALKER, False, 1, NUM_SMS, True, False),            # the closed loop: a cluster a member
    ((23, 300, 300, 36), False, 20_000, NUM_SMS, True, False),  # the wide route
    ((23, 200, 200, 18), False, 20_000, NUM_SMS, False, False),  # a deterministic head
    (WALKER, False, 20_000, None, True, False),          # off the card
    ((23, 64, 64, 200), False, 20_000, NUM_SMS, True, False),  # a head too wide to stage
], ids=["walker", "humanoid", "bf16", "M", "tile", "cluster", "wide", "deterministic", "cpu",
        "wide_head"])
def test_the_dispatch_rule(dims, low, rows, num_sms, gaussian, fused):
    assert kernels.k3_fuses_head(_layout(dims, low), rows, ELITES, num_sms, gaussian) == fused


@pytest.mark.parametrize("out", [1, 18, 46, 127, 128])
def test_the_epilogue_finds_each_element_s_row_by_a_multiply(out):
    """``pair_gaussian_head`` takes element i of a warp's 16 rows to row
    ``(i * div) >> 20``, ``div = ceil(2^20 / out)`` (``PairHead.div``), which
    is ``i // out`` for every element of a head up to the chain's width."""
    div = ((1 << 20) + out - 1) // out
    assert all((i * div) >> 20 == i // out for i in range(16 * out))


def test_the_cpu_keeps_the_glue_and_counts_it():
    model, params = _model("walker")
    x, perm, _ = _inputs("walker", ELITES * 40)
    assert not model._fuses_head(model.packed(params), x, ELITES)
    kernels.reset_launch_counts()
    model._forward_sharded(params, x, perm)
    counts = kernels.launch_counts()
    assert counts["_forward_sharded.glue"] == 1 and counts["fused_ensemble_mlp.fused_head"] == 0


class _Library:
    """Stands in for the built library: records each call after checking it
    against the entry's ctypes signature."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        from mbrl_tpu_torch.ops import build

        argtypes = build.SIGNATURES[name]

        def entry(*args):
            assert len(args) == len(argtypes)
            for t, a in zip(argtypes, args):
                t.from_param(a)
            self.calls.append((name, args))
            return 0

        return entry


@pytest.mark.parametrize("sample", [True, False], ids=["drawn", "mean"])
def test_the_wrapper_hands_the_head_entry_its_arguments(monkeypatch, sample):
    from mbrl_tpu_torch.ops import build

    lib = _Library()
    monkeypatch.setattr(kernels, "_dispatch", lambda t: True)
    monkeypatch.setattr(kernels, "_stream", lambda device: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: NUM_SMS)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    model, params = _model("humanoid")
    stack = model.packed(params).stack
    tiles = kernels.pack_tiles(stack)
    rows = 20_001  # a ragged last tile
    x, perm, noise = _inputs("humanoid", ELITES * rows)
    bounds = (params["max_logvar"], params["min_logvar"])
    kernels.reset_launch_counts()
    out, lv = kernels.fused_ensemble_mlp(x.reshape(ELITES, rows, -1), stack, tiles=tiles, perm=perm,
                                         logvar_bounds=bounds, noise=noise if sample else None)
    assert out.shape == (ELITES * rows, 46) and (lv is None) == sample
    assert not sample or lv is None
    [(name, args)] = lib.calls
    assert name == "mbrl_ensemble_mlp_head"
    assert args[0] == x.data_ptr() and args[3] == perm.data_ptr() and args[7] == out.data_ptr()
    assert args[6] == (noise.data_ptr() if sample else None)
    assert args[8] == (None if sample else lv.data_ptr())
    assert args[11:15] == (ELITES, rows, kernels.k3_blocks("pair", rows, ELITES, NUM_SMS),
                           kernels.ACTIVATION_CODES["silu"])
    assert args[16] == tiles.layout.member_elems and args[17] == 46
    counts = kernels.launch_counts()
    assert counts["fused_ensemble_mlp.fused_head"] == counts["fused_ensemble_mlp.pair"] == 1
    with pytest.raises(ValueError, match="two-tile route"):  # one tile a block: no fused head
        kernels.fused_ensemble_mlp(x[:ELITES * 1600].reshape(ELITES, 1600, -1), stack, tiles=tiles,
                                   perm=perm[:ELITES * 1600], logvar_bounds=bounds)
    with pytest.raises(ValueError, match="come together"):
        kernels.fused_ensemble_mlp(x.reshape(ELITES, rows, -1), stack, tiles=tiles, perm=perm)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda"


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()


@pytest.mark.card
@pytest.mark.parametrize("sample", [True, False], ids=["drawn", "mean"])
@pytest.mark.parametrize("rows", [100_000, 100_005])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_the_kernel_matches_its_plain_version(card, name, rows, sample):
    model, params = _model(name, card)
    x, perm, noise = _inputs(name, rows, card)
    noise = noise if sample else None
    cached = model.packed(params)
    kernels.reset_launch_counts()
    got = _head(model, params, x, perm, noise)
    ref = kernels.fused_ensemble_mlp_head_plain(
        x.reshape(ELITES, -1, x.shape[-1]), cached.stack, perm, params["max_logvar"],
        params["min_logvar"], noise)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_ensemble_mlp.fused_head"] == 1
    gaps = [rel_gap(got[0], ref[0])] + ([] if sample else [rel_gap(got[1], ref[1])])
    print(f"k3 head {name} rows={rows} sample={sample}: largest gap {max(gaps):.3e}")
    assert max(gaps) <= REL, gaps


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_the_kernel_matches_the_glue_it_replaces(card, name, dtype):
    """The same products (the raw K3 of either dtype), then PyTorch's head
    on the card against the kernel's epilogue: the head's arithmetic alone."""
    model, params = _model(name, card, dtype=dtype)
    x, perm, noise = _inputs(name, 100_005, card)
    got, want = _head(model, params, x, perm, noise), _glue(model, params, x, perm, noise)
    gap = rel_gap(got[0], want[0])
    print(f"k3 head against the glue {name} {dtype}: largest gap {gap:.3e}, "
          f"equal {torch.equal(got[0], want[0])}")
    assert gap <= REL


@pytest.mark.card
def test_an_imagined_rollout_takes_the_fused_head_every_step(card):
    """One fused-head launch a step of a 100,000-row rollout; an 8,000-row
    step (one tile a block) keeps the glue."""
    rows, horizon = 100_000, 3
    g = torch.Generator(device=card).manual_seed(0)
    model = GaussianMLP(23, 18, num_layers=4, ensemble_size=MEMBERS, hid_size=200,
                        activation="silu", propagation_method="random_model", device=card)
    wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=True,
                                    normalize_double_precision=True, learned_rewards=True)
    state = wrapper.init(g)
    state["params"] = model.set_elite(state["params"], [0, 2, 3, 5, 6])
    env = ModelEnv(wrapper, lambda act, obs: torch.zeros((obs.shape[0], 1), dtype=torch.bool,
                                                         device=obs.device), None)
    sac = SAC(17, Box(-torch.ones(6).numpy(), torch.ones(6).numpy()), hidden_size=256,
              device=card)
    policy = sac.init(g).policy
    buf = DeviceReplayBuffer(rows * horizon + 1, 17, 6, device=card)
    obs0 = torch.randn((rows, 17), generator=g, device=card)
    kernels.reset_launch_counts()
    mbpo.imagined_rollout(env, state, sac, policy, buf, buf.init(), obs0, g, horizon, True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["fused_ensemble_mlp.fused_head"] == counts["fused_ensemble_mlp.pair"] == horizon
    assert counts["_forward_sharded.glue"] == 0
    kernels.reset_launch_counts()
    small = env.reset(state, obs0[:8000], g)
    env.step(state, torch.zeros((8000, 6), device=card), small, g, sample=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["_forward_sharded.glue"] == counts["fused_ensemble_mlp.tile"] == 1
    assert counts["fused_ensemble_mlp.fused_head"] == 0
