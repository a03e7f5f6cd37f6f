"""The two paths that live on kernel K3 (mbrl_tpu_torch/ops/kernels.py:
fused_ensemble_mlp), on the CPU: ``GaussianMLP._forward_sharded`` under
``ModelEnv.step``, and what surrounds the kernel on the card.

- the persistent tile schedule (``persistent_blocks`` / ``block_tiles``, which
  the kernel's tile loop mirrors) covers every tile of every member once, and
  so does the two-tile route's pair schedule (``pair_blocks`` /
  ``block_pairs``), each pair within one member;
- the route K3 takes on the chain (``k3_route`` / ``k3_blocks``, mirrored from
  ``mbrl_ensemble_mlp``) by shape, and the arguments the wrapper hands the
  entry for each route, against a stand-in library;
- the widths: ``_forward_sharded`` goes through the wrapper at every width and
  matches mbrl_tpu's ``_forward_sharded`` on converted weights (1e-5, f32
  float-sum order); on the card the tensor-core chain takes up to 256 columns
  and the wide route the rest;
- the packed-weights cache: one pack over a rollout of steps, a fresh pack
  after ``set_elite`` and after new weights;
- the plain chain leaves ``allow_tf32`` as the caller set it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbrl_tpu.models import GaussianMLP as JaxGaussianMLP
from mbrl_tpu_torch import convert
from mbrl_tpu_torch.envs import termination_fns
from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, TransitionRewardModel
from mbrl_tpu_torch.ops import kernels

IN, OUT, E = 6, 4, 3
NUM_SMS = 132  # an H100's


@pytest.mark.parametrize("members", [1, 5, 7])
@pytest.mark.parametrize("rows", [1, 63, 64, 1_600, 20_000])
def test_tile_schedule_covers_every_tile_once(rows, members):
    num_tiles = -(-rows // kernels.MAX_TILE)
    blocks = kernels.persistent_blocks(rows, members, NUM_SMS)
    assert 1 <= blocks <= min(NUM_SMS, members * num_tiles)
    shares = [kernels.block_tiles(b, rows, members, blocks) for b in range(blocks)]
    seen = sorted(pair for share in shares for pair in share)
    assert seen == [(m, t) for m in range(members) for t in range(num_tiles)]
    sizes = [len(s) for s in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # every row of a member lies in one of its tiles
    assert num_tiles * kernels.MAX_TILE >= rows > (num_tiles - 1) * kernels.MAX_TILE


def test_tile_schedule_at_the_main_shapes():
    # 8,000 rows over 5 elites: one wave, one tile a block
    assert kernels.persistent_blocks(1_600, 5, NUM_SMS) == 125
    # 100,000 rows: 1,565 tiles over 132 persistent blocks, 11 or 12 each
    assert kernels.persistent_blocks(20_000, 5, NUM_SMS) == NUM_SMS
    sizes = {len(kernels.block_tiles(b, 20_000, 5, NUM_SMS)) for b in range(NUM_SMS)}
    assert sizes == {11, 12}


@pytest.mark.parametrize("members", [1, 5, 7])
@pytest.mark.parametrize("rows", [65, 1_700, 16_000, 20_000, 20_032])
def test_pair_schedule_covers_every_tile_once(rows, members):
    num_tiles = -(-rows // kernels.MAX_TILE)
    blocks = kernels.pair_blocks(rows, members, NUM_SMS)
    assert 1 <= blocks <= min(NUM_SMS, members * -(-num_tiles // 2))
    shares = [kernels.block_pairs(b, rows, members, blocks) for b in range(blocks)]
    seen = sorted((m, t) for share in shares for m, pair in share for t in pair)
    assert seen == [(m, t) for m in range(members) for t in range(num_tiles)]
    for share in shares:
        assert share == sorted(share)  # member-major
        for m, pair in share:  # two tiles of one member, 2k and 2k + 1; an odd last one alone
            assert pair[0] % 2 == 0 and list(pair) == list(range(pair[0], pair[0] + len(pair)))
            assert len(pair) == 2 or pair[0] == num_tiles - 1
    sizes = [len(s) for s in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_pair_schedule_at_the_main_shapes():
    # 100,000 rows over 5 elites: 313 tiles a member (the last one alone), 785
    # pairs over 132 blocks, 5 or 6 each; config M's 80,000: 625 pairs, 4 or 5
    assert kernels.pair_blocks(20_000, 5, NUM_SMS) == NUM_SMS
    assert {len(kernels.block_pairs(b, 20_000, 5, NUM_SMS)) for b in range(NUM_SMS)} == {5, 6}
    assert {len(kernels.block_pairs(b, 16_000, 5, NUM_SMS)) for b in range(NUM_SMS)} == {4, 5}
    assert kernels.block_pairs(0, 20_000, 5, NUM_SMS)[:2] == [(0, (0, 1)), (0, (264, 265))]
    assert (0, (312,)) in kernels.block_pairs(156 % NUM_SMS, 20_000, 5, NUM_SMS)


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,members,route,blocks", [
    (1, 5, "cluster", 40),        # one row per elite: clusters of 8 blocks a member
    (2, 5, "cluster", 40),
    (8, 5, None, 40),             # f32's last cluster shape; bf16's one tile a block
    (9, 5, "tile", 5),
    (64, 5, "tile", 5),
    (65, 5, "tile", 10),
    (1, 7, "cluster", 56),        # all 7 members: 8 blocks each still fit
    (1, 20, "cluster", 120),      # clusters of 6
    (1, 67, "tile", 67),          # 132 // 67 = 1: no cluster of two for every member
    (1_600, 5, "tile", 125),      # C8k and D: one wave
    (1_664, 5, "tile", 130),
    (1_700, 5, "pair", 70),       # 135 tiles: past one wave, 14 pairs a member
    (16_000, 5, "pair", 132),     # M
    (20_000, 5, "pair", 132),     # C100k
])
def test_k3_route_by_shape(rows, members, route, blocks, low_precision):
    if route is None:
        route = "tile" if low_precision else "cluster"
        blocks = 5 if low_precision else blocks
    assert kernels.k3_route(rows, members, NUM_SMS, low_precision) == route
    assert kernels.k3_blocks(route, rows, members, NUM_SMS) == blocks
    if route == "cluster":
        assert members * kernels.cluster_size(members, NUM_SMS) == blocks <= NUM_SMS
        assert 2 <= kernels.cluster_size(members, NUM_SMS) <= kernels.CLUSTER_MAX


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrapper_hands_each_route_its_grid_and_weights(monkeypatch, dtype):
    from mbrl_tpu_torch.ops import build

    lib = _Library()
    monkeypatch.setattr(kernels, "_dispatch", lambda t: True)
    monkeypatch.setattr(kernels, "_stream", lambda device: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: NUM_SMS)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    dims = (24, 200, 200, 36)
    stack = kernels.pack_mlp([torch.randn(5, 24, 200), torch.randn(5, 200, 200)],
                             [torch.zeros(5, 1, 200)] * 2, torch.randn(5, 200, 36),
                             torch.zeros(5, 1, 36), "silu", dtype=dtype)
    tiles = kernels.pack_tiles(stack)
    for rows in (1, 100, 20_000):
        kernels.fused_ensemble_mlp(torch.zeros((5, rows, 24)), stack, tiles=tiles)
    routes = [kernels.k3_route(r, 5, NUM_SMS, dtype == torch.bfloat16) for r in (1, 100, 20_000)]
    assert routes == ["cluster", "tile", "pair"]
    for (name, args), rows, route in zip(lib.calls, (1, 100, 20_000), routes):
        assert name == "mbrl_ensemble_mlp" and args[7] == rows
        assert args[8] == kernels.k3_blocks(route, rows, 5, NUM_SMS)
        assert args[11] == kernels.ChainLayout(dims, dtype == torch.bfloat16).member_elems
        assert args[12] == stack.ws.data_ptr() and args[13] == kernels.K3_ROUTES.index(route)


def _pair(hid, **kw):
    common = dict(in_size=IN, out_size=OUT, num_layers=2, ensemble_size=E, hid_size=hid,
                  activation="silu", propagation_method="random_model")
    common.update(kw)
    jm, tm = JaxGaussianMLP(**common), GaussianMLP(device="cpu", **common)
    params = jm.init(jax.random.PRNGKey(0))
    params["layers"][0]["b"] = 0.1 * jnp.ones_like(params["layers"][0]["b"])
    params = jm.set_elite(params, [0, 2])
    return jm, tm, params, convert.convert_params(jax.tree_util.tree_map(np.asarray, params), "cpu")


@pytest.mark.parametrize("deterministic", [False, True], ids=["gaussian", "deterministic"])
@pytest.mark.parametrize("hid,chain_takes_it", [(200, True), (248, True), (264, False)])
def test_forward_sharded_width_gate(monkeypatch, hid, chain_takes_it, deterministic):
    """Every width goes through the K3 wrapper (on CPU tensors its plain
    version, which has no limit); on the card the tensor-core chain takes up
    to 256 columns and the wide route the rest."""
    calls = []
    orig = kernels.fused_ensemble_mlp
    monkeypatch.setattr(kernels, "fused_ensemble_mlp",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    jm, tm, jp, tp = _pair(hid, deterministic=deterministic)
    dims = tm.packed(tp).stack.dims
    assert kernels.supports_fused_mlp(dims)
    assert kernels.takes_chain(dims, False) == chain_takes_it
    batch = 12
    x = np.random.default_rng(2).standard_normal((batch, IN)).astype(np.float32)
    perm = np.random.default_rng(3).permutation(batch)
    jmean, jlv = jm._forward_sharded(jp, jnp.asarray(x), jnp.asarray(perm, jnp.int32))
    tmean, tlv = tm._forward_sharded(tp, torch.from_numpy(x), torch.from_numpy(perm))
    assert len(calls) == 1
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-5)
    if deterministic:
        assert jlv is None and tlv is None
    else:
        np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), rtol=1e-5, atol=1e-5)


def test_supports_fused_mlp_is_what_the_kernels_take():
    assert kernels.supports_fused_mlp((23, 256, 256, 36))
    # wider layers and deeper chains take the wide route instead of raising
    assert kernels.supports_fused_mlp((23, 257, 36))
    assert kernels.supports_fused_mlp((23,) + (8,) * 9 + (36,))  # 10 products
    assert not kernels.takes_chain((23, 257, 36), False)
    assert not kernels.takes_chain((23,) + (8,) * 9 + (36,), False)
    # the wrappers' own check takes the wide stack; it refuses only what no
    # route takes (here a stack whose weights do not match its dims)
    wide = kernels.pack_mlp([torch.zeros(1, 23, 257)], [torch.zeros(1, 1, 257)],
                            torch.zeros(1, 257, 36), torch.zeros(1, 1, 36), "silu")
    kernels._check_stack(wide, torch.device("cpu"))
    with pytest.raises(ValueError):
        kernels._check_stack(kernels.MLPStack(wide.ws[:, 1:].contiguous(), wide.bs, wide.dims,
                                              "silu"), torch.device("cpu"))
    # every width the chain takes leaves room for the weight ring, in both dtypes
    for low in (False, True):
        assert kernels.ChainLayout((256, 256, 256), low).stages() >= 2


def _env(hid=16):
    model = GaussianMLP(IN, OUT, num_layers=2, ensemble_size=E, hid_size=hid, activation="silu",
                        propagation_method="random_model", device="cpu")
    wrapper = TransitionRewardModel(model, target_is_delta=True, normalize=False,
                                    learned_rewards=True)
    g = torch.Generator().manual_seed(0)
    state = wrapper.set_elite(wrapper.init(g), [0, 2])
    return ModelEnv(wrapper, termination_fns.no_termination), wrapper, state, g


def _rollout(env, state, g, steps=5, rows=8):
    obs = 0.1 * torch.randn((rows, OUT - 1), generator=g)
    model_state = env.reset(state, obs, g)
    model_state = env.dynamics_model.prepare_rollout(state, model_state, steps, g)
    for _ in range(steps):
        act = torch.rand((rows, IN - OUT + 1), generator=g)
        obs, _, _, model_state = env.step(state, act, model_state, g)
    return obs


def test_weights_packed_once_per_rollout_and_anew_when_they_change(monkeypatch):
    packs = []
    orig = kernels.pack_mlp
    monkeypatch.setattr(kernels, "pack_mlp", lambda *a, **k: packs.append(1) or orig(*a, **k))
    env, wrapper, state, g = _env()
    model = wrapper.model
    _rollout(env, state, g)
    assert len(packs) == 1 and model.packs == 1
    _rollout(env, state, g)  # the same state again: still the first pack
    assert len(packs) == 1

    elite = wrapper.set_elite(state, [1, 2])  # other elites: a fresh pack
    out_elite = _rollout(env, elite, torch.Generator().manual_seed(1))
    assert len(packs) == 2
    out_first = _rollout(env, state, torch.Generator().manual_seed(1))
    assert len(packs) == 3 and not torch.equal(out_elite, out_first)

    # new weights in place (an optimizer step): noticed by the tensors' versions
    state["params"]["head"]["w"].mul_(2.0)
    out_scaled = _rollout(env, state, torch.Generator().manual_seed(1))
    assert len(packs) == 4 and not torch.equal(out_scaled, out_first)

    # new weight tensors in a new params dict (a loaded checkpoint)
    fresh = {**state, "params": {**state["params"],
                                 "head": {k: v.clone() for k, v in state["params"]["head"].items()}}}
    out_fresh = _rollout(env, fresh, torch.Generator().manual_seed(1))
    assert len(packs) == 5 and model.packs == 5
    torch.testing.assert_close(out_fresh, out_scaled)

    # another compute dtype on the same tensors
    model.compute_dtype = torch.bfloat16
    assert model.packed(fresh["params"]).stack.low_precision and len(packs) == 6


def test_cached_steps_match_uncached_forward():
    """A step served from the cache gives what a freshly packed stack gives."""
    env, wrapper, state, g = _env()
    model = wrapper.model
    x = torch.randn((8, IN), generator=g)
    perm = torch.randperm(8, generator=g)
    first = model._forward_sharded(state["params"], x, perm)
    again = model._forward_sharded(state["params"], x, perm)
    view = model._elite_view(state["params"])
    raw = kernels.fused_ensemble_mlp_plain(x[perm].reshape(2, 4, IN), model.pack(view))
    mean, logvar = model._bound(view, raw)
    inv = torch.argsort(perm)
    assert model.packs == 1
    for got in (first, again):
        torch.testing.assert_close(got[0], mean.reshape(8, -1)[inv])
        torch.testing.assert_close(got[1], logvar.reshape(8, -1)[inv])


@pytest.mark.parametrize("setting", [True, False])
def test_plain_chain_leaves_allow_tf32_as_the_caller_set_it(setting):
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = setting
        stack = kernels.pack_mlp([torch.randn(2, 5, 8)], [torch.zeros(2, 1, 8)],
                                 torch.randn(2, 8, 3), torch.zeros(2, 1, 3), "relu")
        out = kernels.fused_ensemble_mlp(torch.randn(2, 4, 5), stack)
        assert out.shape == (2, 4, 3)
        assert torch.backends.cuda.matmul.allow_tf32 is setting
        with pytest.raises(RuntimeError):  # a failing product restores it too
            kernels.fused_ensemble_mlp_plain(torch.randn(2, 4, 6), stack)
        assert torch.backends.cuda.matmul.allow_tf32 is setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
