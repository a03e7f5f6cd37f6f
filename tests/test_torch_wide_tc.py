"""The wide tensor-core route of K1, K2 (``csrc/wide_tc.cu``) and K3
(``csrc/ensemble_mlp_wide.cu``), on the CPU.

Every stack the tensor-core chain does not take reaches K1, K2 and K3 through
this route: the weights packed by ``pack_wide`` (``WideTileLayout``: per product,
per pass of up to 256 output columns, per K chunk, in ``wgmma``'s layout, f32
as tf32 hi and lo copies), the activations streamed from a per-block scratch.
These tests check, without a GPU:

- the layout: every element of every product lands where the kernel reads it
  (a single 1 at chosen positions), the packed tiles unpack exactly to the
  padded weights, and the f32 copies are the tf32 split (hi rounded to
  nearest, ties away from zero; hi + lo within 2^-22 of the weight);
- the scratch and the shared-memory plan that ``make_wide_desc`` mirrors;
- a chunk-by-chunk emulation of the kernel's products on the packed tiles
  (3xTF32 for f32: a_lo w_hi + a_hi w_lo + a_hi w_hi; bf16 operands for
  bf16), with its padding, masks and rounding points, through K3's raw head
  (Gaussian and deterministic) and K2's and K1's Gaussian heads: f32 against
  the JAX kernels in interpret mode, bf16 against the plain versions;
- K3's schedule: the persistent blocks walk every (member, row tile) pair
  once, ragged tiles included, and its scratch is sized for those blocks;
- the wrappers' CUDA branch against a stand-in library: the wide entries get
  ``pack_wide``'s tiles and a scratch of the layout's size, and tiles of
  another stack or packed for the other route are refused.

Tolerances (|diff| <= atol + rtol |ref|): f32 1e-5 (3xTF32 drops a_lo w_lo and
rounds lo to tf32, about 2^-22 relative a product; the emulation sums in
float64, the reference in float32); bf16 1e-2 (the same rounding points, but
an f32 ulp of difference can flip one bf16 rounding, 2^-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mbrl_tpu.models.gaussian_mlp import _ACTIVATIONS
from mbrl_tpu.ops import pallas_kernels as pk
from mbrl_tpu_torch.ops import kernels as tk
from test_torch_wide_route import _stack, fake_card  # noqa: F401 (a fixture)

WIDE_DIMS = {
    "w264": (24, 264, 264, 36),
    "w300": (24, 300, 300, 36),
    "w600": (23, 600, 36),  # three passes, the last 88 (f32) or 96 (bf16) wide
    "w1024": (24, 1024, 1024, 36),
    "deep12": (24,) + (64,) * 11 + (36,),  # 12 products
    "det18": (24, 300, 300, 18),  # a deterministic model's head: out, not 2 x out
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _offset(lay, i, k, n):
    """Where the kernel reads element (k, n) of product i's first copy."""
    kp, t = lay.k_pad[i], lay.t
    p0 = n // tk.WIDE_PASS * tk.WIDE_PASS
    width = min(tk.WIDE_PASS, lay.n_pad[i] - p0)
    k0 = k // lay.chunk * lay.chunk
    kl, nl = k - k0, n - p0
    core = ((kl // t * (width // 8) + nl // 8) * 8 + nl % 8) * t + kl % t
    return lay.product_offset(i) + p0 * kp * lay.copies + k0 * width * lay.copies + core


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["w300", "w600", "deep12"])
def test_each_weight_lands_where_the_kernel_reads_it(name, dt):
    dims = WIDE_DIMS[name]
    stack = _stack(dims, DTYPES[dt], e=1)
    lay = tk.WideTileLayout(dims, stack.low_precision)
    for i in (0, 1, stack.num_products - 1):
        k_last, n_last = dims[i] - 1, dims[i + 1] - 1
        for k, n in {(0, 0), (k_last, n_last), (k_last // 2, n_last), (min(k_last, 17), min(n_last, 263))}:
            ws = torch.zeros_like(stack.ws)
            w0 = sum(a * b for a, b in zip(dims[:i], dims[1 : i + 1]))  # product i in MLPStack.ws
            ws[0, w0 + k * dims[i + 1] + n] = 1.0
            tiles = tk.pack_wide(tk.MLPStack(ws, stack.bs, dims, "silu"))
            hot = torch.nonzero(tiles.w[0]).flatten().tolist()
            assert hot == [_offset(lay, i, k, n)], (i, k, n)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", [n for n in WIDE_DIMS if n != "det18"])
def test_wide_tiles_unpack_to_the_padded_weights(name, dt):
    dims = WIDE_DIMS[name]
    stack = _stack(dims, DTYPES[dt], seed=1, e=3)
    tiles = tk.pack_wide(stack)
    lay = tiles.layout
    assert isinstance(lay, tk.WideTileLayout) and tiles.w.dtype == stack.ws.dtype
    # the same padding and size as the chain's layout, in another order
    assert lay.member_elems == tk.ChainLayout(dims, stack.low_precision).member_elems
    assert tiles.w.shape == (3, lay.member_elems)
    for i in range(stack.num_products):
        w, _ = stack.product(i)
        kp, np_ = lay.k_pad[i], lay.n_pad[i]
        assert kp % (16 if stack.low_precision else 8) == 0 and np_ % 8 == 0
        padded = F.pad(w, (0, np_ - w.shape[2], 0, kp - w.shape[1]))
        copies = tk.unpack_chain(tiles, i)
        assert lay.product_offset(i + 1) - lay.product_offset(i) == kp * np_ * lay.copies
        if stack.low_precision:
            assert torch.equal(copies[0], padded)
        else:
            hi, lo = copies
            assert torch.equal(hi, tk.rna_tf32(padded))
            assert torch.equal(lo, tk.rna_tf32(padded - hi))
        # the padding is zero in every copy
        for c in copies:
            assert not c[:, w.shape[1]:].any() and not c[:, :, w.shape[2]:].any()


def test_the_tf32_split_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(10_000) * 10.0 ** rng.integers(-3, 4, 10_000)).astype(np.float32)
    # ties: a tf32 value plus exactly half its ulp
    base = (rng.standard_normal(100).astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000))
    ties = (base | np.uint32(0x1000)).view(np.float32)
    hi = tk.rna_tf32(torch.from_numpy(x)).numpy()
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    half_ulp = np.ldexp(1.0, np.frexp(x)[1] - 12)  # tf32 keeps 10 mantissa bits
    assert (np.abs(hi.astype(np.float64) - x) <= half_ulp).all()
    tie_hi = tk.rna_tf32(torch.from_numpy(ties)).numpy()
    np.testing.assert_array_equal(tie_hi.view(np.uint32), base + np.uint32(0x2000))
    lo = tk.rna_tf32(torch.from_numpy(x) - torch.from_numpy(hi)).numpy()
    assert (np.abs(hi.astype(np.float64) + lo - x) <= np.abs(x) * 2.0**-21).all()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", [n for n in WIDE_DIMS if n != "det18"])
def test_the_scratch_and_the_ring_mirror_make_wide_desc(name, dt):
    dims = WIDE_DIMS[name]
    low = dt == "bf16"
    lay = tk.WideTileLayout(dims, low)
    esize, copies = (2, 1) if low else (4, 2)
    assert lay.chunk * esize * copies == 128  # one A chunk slot: 64 rows x 128 bytes
    widest = min(tk.WIDE_PASS, max(lay.n_pad))
    assert lay.stage_bytes == 64 * 128 + lay.chunk * widest * esize * copies
    assert lay.stage_bytes <= 40_960 and lay.stages() == tk.TC_MAX_STAGES
    assert lay.stages(4 * tk.MAX_TILE * 18) == lay.stages()  # K1's carry is in the scratch
    a_buf = 64 * max(lay.k_pad) * esize * copies
    head = 4 * 64 * lay.n_pad[-1]
    assert lay.block_bytes() == -(-(2 * a_buf + head) // 128) * 128
    assert lay.block_bytes(17) == -(-(2 * a_buf + head + 4 * 64 * 18) // 128) * 128
    for i in range(len(dims) - 1):
        passes = lay.passes(i)
        assert sum(w for _, w in passes) == lay.n_pad[i]
        assert all(w % 8 == 0 and 0 < w <= tk.WIDE_PASS for _, w in passes)


def _tf32_pair(a):
    hi = tk.rna_tf32(a)
    return hi.double(), tk.rna_tf32(a - hi).double()


def _emulated_wide_tc_chain(x: torch.Tensor, stack: tk.MLPStack, tiles) -> torch.Tensor:
    """The wide tensor-core route's arithmetic on the packed tiles, pass by
    pass and chunk by chunk: f32 as 3xTF32 on tf32-split operands, bf16 on
    bf16 operands; sums in float64; bias, then activation and (bf16) rounding
    of the hidden layers; padded columns zero; the head in f32."""
    lay, low = tiles.layout, stack.low_precision
    act = tk.ACTIVATIONS[stack.activation]
    outs = []
    for m in range(stack.num_members):
        a = F.pad(x[m].float(), (0, lay.k_pad[0] - x.shape[-1]))
        if low:
            a = a.to(torch.bfloat16).float()
        for i in range(stack.num_products):
            copies = [c[m] for c in tk.unpack_chain(tiles, i)]
            hidden = i + 1 < stack.num_products
            dout = stack.dims[i + 1]
            _, b = stack.product(i)
            bias = F.pad(b[m, 0], (0, lay.n_pad[i] - dout))
            dst = torch.zeros((a.shape[0], lay.n_pad[i]))
            for p0, width in lay.passes(i):
                acc = torch.zeros((a.shape[0], width), dtype=torch.float64)
                for k0 in range(0, lay.k_pad[i], lay.chunk):
                    ac = a[:, k0 : k0 + lay.chunk]
                    wc = [c[k0 : k0 + lay.chunk, p0 : p0 + width].double() for c in copies]
                    if low:
                        acc += ac.double() @ wc[0]
                    else:
                        a_hi, a_lo = _tf32_pair(ac)
                        acc += a_lo @ wc[0] + a_hi @ wc[1] + a_hi @ wc[0]
                v = acc.float() + bias[p0 : p0 + width]
                if hidden:
                    v = act(v)
                    v[:, max(0, dout - p0):] = 0.0  # the next product's K padding
                    if low:
                        v = v.to(torch.bfloat16).float()
                dst[:, p0 : p0 + width] = v
            a = dst
        outs.append(a[:, : stack.dims[-1]])
    return torch.stack(outs)


def _jax_weights(stack):
    layers = [stack.product(i) for i in range(stack.num_products)]
    return (tuple(jnp.asarray(w.float().numpy()) for w, _ in layers[:-1]),
            tuple(jnp.asarray(b.numpy()) for _, b in layers[:-1]),
            jnp.asarray(layers[-1][0].float().numpy()), jnp.asarray(layers[-1][1].numpy()))


def _bounds(out):
    rng = np.random.default_rng(9)
    return (0.5 + 0.1 * rng.standard_normal((1, out))).astype(np.float32), \
        (-10.0 + 0.1 * rng.standard_normal((1, out))).astype(np.float32)


@pytest.fixture
def emulated_chain(monkeypatch):
    """The plain versions' heads around the emulated wide route's chain."""
    def chain(x, stack):
        return _emulated_wide_tc_chain(x, stack, tk.pack_wide(stack))

    monkeypatch.setattr(tk, "_plain_chain", chain)


@pytest.mark.parametrize("name", ["w300", "deep12", "det18"])
def test_emulated_k3_matches_the_jax_kernel(name, emulated_chain):
    e, dims = 2, WIDE_DIMS[name]
    stack = _stack(dims, torch.float32, seed=12, e=e)
    x = np.random.default_rng(13).standard_normal((e, 24, dims[0])).astype(np.float32)
    ref = pk.fused_ensemble_mlp(jnp.asarray(x), *_jax_weights(stack),
                                activation=_ACTIVATIONS["silu"], tile=8, interpret=True)
    got = tk.fused_ensemble_mlp(torch.from_numpy(x), stack)  # the plain version on the CPU
    assert got.shape == (e, 24, dims[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["w300", "deep12"])
def test_emulated_k2_matches_the_jax_kernel(name, emulated_chain):
    e, dims = 2, WIDE_DIMS[name]
    out = dims[-1] // 2
    stack = _stack(dims, torch.float32, seed=5, e=e)
    x = np.random.default_rng(6).standard_normal((e, 16, dims[0])).astype(np.float32)
    maxlv, minlv = _bounds(out)
    ref = pk.fused_ensemble_mlp_gaussian(
        jnp.array([1, 2], jnp.int32), jnp.asarray(x), *_jax_weights(stack), jnp.asarray(maxlv),
        jnp.asarray(minlv), out_size=out, activation=_ACTIVATIONS["silu"], tile=8, sample=False,
        interpret=True,
    )
    got = tk.fused_ensemble_mlp_gaussian_plain(
        torch.Generator().manual_seed(0), torch.from_numpy(x), stack, torch.from_numpy(maxlv),
        torch.from_numpy(minlv), out, sample=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["w300", "deep12"])
def test_emulated_k1_matches_the_jax_kernel(name, emulated_chain):
    e, tile, horizon, batch = 2, 8, 3, 32
    obs_dim, act_dim = 17, 6
    dims = (obs_dim + act_dim,) + WIDE_DIMS[name][1:]
    out = dims[-1] // 2
    stack = _stack(dims, torch.float32, seed=7, e=e)
    rng = np.random.default_rng(8)
    obs0 = (0.5 * rng.standard_normal((batch, obs_dim))).astype(np.float32)
    acts = rng.uniform(-1, 1, (batch, horizon, act_dim)).astype(np.float32)
    rot = np.array([0, 3, 1], np.int32)
    dmask = np.ones((1, obs_dim), np.float32)
    dmask[0, 2] = 0.0
    maxlv, minlv = _bounds(out)
    ref = pk.fused_rollout_returns(
        jnp.array([3, 4], jnp.int32), jnp.asarray(rot), jnp.asarray(obs0), jnp.asarray(acts),
        jnp.asarray(dmask), *_jax_weights(stack), jnp.asarray(maxlv), jnp.asarray(minlv),
        out_size=out, activation=_ACTIVATIONS["silu"], tile=tile, sample=False, interpret=True,
    )
    t = torch.from_numpy
    got = tk.fused_rollout_returns_plain(
        torch.Generator().manual_seed(0), t(rot), t(obs0), t(acts), t(dmask), stack, t(maxlv),
        t(minlv), out, tile, sample=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["w300", "w600", "deep12", "det18"])
def test_emulated_bf16_matches_the_plain_versions(name):
    e, dims = 2, WIDE_DIMS[name]
    out = dims[-1] // 2
    stack = _stack(dims, torch.bfloat16, seed=10, e=e)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((e, 37, dims[0])).astype(np.float32))
    got = _emulated_wide_tc_chain(x, stack, tk.pack_wide(stack))
    # K3's raw head (both kinds), then K2's mean of a Gaussian head
    torch.testing.assert_close(got, tk.fused_ensemble_mlp(x, stack), rtol=1e-2, atol=1e-2)
    maxlv, minlv = (torch.from_numpy(b) for b in _bounds(out))
    g = torch.Generator().manual_seed(0)
    mean = tk.fused_ensemble_mlp_gaussian_plain(g, x, stack, maxlv, minlv, out, sample=False)
    torch.testing.assert_close(got[..., :out], mean, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["w264", "w1024", "deep12"])
def test_the_wide_entries_get_wide_tiles_and_their_scratch(fake_card, name, dt):
    lib = fake_card
    dims = WIDE_DIMS[name]
    stack = _stack(dims, DTYPES[dt], e=5)
    lay = tk.WideTileLayout(dims, stack.low_precision)
    tiles = tk.pack_wide(stack)
    g = torch.Generator().manual_seed(0)
    lv = torch.zeros((1, 18))
    tk.fused_ensemble_mlp(torch.zeros((5, 100, 24)), stack, tiles=tiles)
    tk.fused_ensemble_mlp_gaussian(g, torch.zeros((5, 100, 24)), stack, lv, lv, 18, tiles=tiles)
    stack1 = _stack((23,) + dims[1:], DTYPES[dt], e=5)
    lay1 = tk.WideTileLayout(stack1.dims, stack1.low_precision)
    batch, horizon = 640, 3
    tiles1 = tk.pack_wide(stack1)
    tk.fused_rollout_returns(
        g, torch.zeros(horizon, dtype=torch.int32), torch.zeros((batch, 17)),
        torch.zeros((batch, horizon, 6)), torch.ones((1, 17)), stack1, lv, lv, 18, 64,
        tiles=tiles1,
    )
    (k3, a3), (k2, a2), (k1, a1) = lib.calls
    assert (k3, k2, k1) == ("mbrl_ensemble_mlp_wide", "mbrl_ensemble_mlp_gaussian_wide",
                            "mbrl_rollout_returns_wide")
    assert a3[1] == tiles.w.data_ptr() and a3[11] == int(stack.low_precision)
    assert a3[12] == lay.member_elems
    assert a3[9] == tk.persistent_blocks(100, 5, 132)
    # K3's route by shape: resident in shared memory up to 512 columns (no
    # scratch), else a scratch of persistent blocks, no K1 carry
    if lay.k3_resident:
        assert a3[-2] == tk.K3_WIDE_ROUTES.index("smem") and a3[-4] is None and a3[-3] == 0
    else:
        assert a3[-2] == tk.K3_WIDE_ROUTES.index("scratch")
        assert a3[-3] == a3[9] * lay.block_bytes()
    assert lay.k3_resident == (name != "w1024")
    assert a2[3] == tiles.w.data_ptr() and a2[17] == lay.member_elems
    assert a2[-2] == 2 * 5 * lay.block_bytes()  # (tiles, E) blocks
    assert a1[6] == tiles1.w.data_ptr() and a1[24] == lay1.member_elems
    assert a1[-2] == (batch // 64) * lay1.block_bytes(17)  # one block per row tile
    k3_route = "smem" if lay.k3_resident else "scratch"
    assert tk.launch_counts() == {"fused_rollout_returns": 1, "fused_ensemble_mlp_gaussian": 1,
                                  "fused_ensemble_mlp": 1, **{
                                      f"fused_ensemble_mlp.{r}": int(r == k3_route)
                                      for r in tk.K3_ROUTES + tk.K3_WIDE_ROUTES},
                                  "fused_ensemble_mlp.fused_head": 0,
                                  "_forward_sharded.glue": 0,
                                  "fused_policy_mlp": 0, "fused_policy_mlp.repacks": 0,
                                  "fused_policy_mlp.linear": 0}


@pytest.mark.parametrize("rows,members", [(1600, 5), (20_000, 5), (100, 5), (1, 1)],
                         ids=["C8k", "C100k", "ragged", "one_row"])
def test_k3_blocks_walk_every_tile_once(rows, members):
    """K3's persistent schedule at one tile a block (8,000 rows on 132 SMs:
    125 pairs), at many (100,000 rows: 1,565 pairs), and over ragged tiles."""
    num_tiles = -(-rows // tk.MAX_TILE)
    pairs = members * num_tiles
    blocks = tk.persistent_blocks(rows, members, 132)
    assert blocks == min(pairs, 132)
    walks = [tk.block_tiles(b, rows, members, blocks) for b in range(blocks)]
    # every (member, tile) pair once, each block member-major in its walk
    assert sorted(p for w in walks for p in w) == [(m, t) for m in range(members) for t in range(num_tiles)]
    assert all(w == sorted(w) for w in walks)
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
    assert max(map(len, walks)) == -(-pairs // blocks)
    # the ragged last tile of each member holds the rows left over
    last = rows - (num_tiles - 1) * tk.MAX_TILE
    assert 1 <= last <= tk.MAX_TILE and (last == tk.MAX_TILE) == (rows % tk.MAX_TILE == 0)


@pytest.mark.parametrize("rows", [1600, 20_000], ids=["C8k", "C100k"])
def test_k3_wide_scratch_is_sized_for_persistent_blocks(fake_card, rows):
    # 4 x 512 takes the resident route (no scratch), 2 x 1024 the scratch
    # route, whose scratch holds the persistent blocks
    dims, wider = (23, 512, 512, 512, 512, 36), (23, 1024, 1024, 36)
    for d in (dims, wider):
        tk.fused_ensemble_mlp(torch.zeros((5, rows, 23)), _stack(d, torch.bfloat16, e=5))
    (name, args), (name_w, args_w) = fake_card.calls
    lay, lay_w = tk.WideTileLayout(dims, True), tk.WideTileLayout(wider, True)
    blocks, pairs = tk.persistent_blocks(rows, 5, 132), 5 * -(-rows // tk.MAX_TILE)
    assert name == name_w == "mbrl_ensemble_mlp_wide" and args[8:10] == args_w[8:10] == (rows, blocks)
    assert lay.k3_resident and args[-2] == tk.K3_WIDE_ROUTES.index("smem")
    assert args[-4] is None and args[-3] == 0
    assert not lay_w.k3_resident and args_w[-2] == tk.K3_WIDE_ROUTES.index("scratch")
    assert args_w[-3] == blocks * lay_w.block_bytes()
    assert (blocks < pairs) == (rows == 20_000)  # past one wave the blocks walk tiles


@pytest.mark.parametrize("dt", list(DTYPES))
def test_k3_refuses_chain_tiles_for_a_wide_stack(fake_card, dt):
    lib = fake_card
    x = torch.zeros((5, 64, 24))
    wide = _stack(WIDE_DIMS["w300"], DTYPES[dt], e=5)
    narrow = _stack((24, 200, 200, 36), DTYPES[dt], e=5)
    for stack, tiles in ((wide, tk.pack_chain(wide)), (narrow, tk.pack_wide(narrow)),
                         (wide, tk.pack_wide(_stack(WIDE_DIMS["w264"], DTYPES[dt], e=5)))):
        with pytest.raises(ValueError):
            tk.fused_ensemble_mlp(x, stack, tiles=tiles)
    assert not lib.calls
    # packed here when none are given, for the route the stack takes
    tk.fused_ensemble_mlp(x, wide)
    tk.fused_ensemble_mlp(x, narrow)
    assert [c[0] for c in lib.calls] == ["mbrl_ensemble_mlp_wide", "mbrl_ensemble_mlp"]
    assert lib.calls[0][1][12] == tk.WideTileLayout(wide.dims, wide.low_precision).member_elems
    assert lib.calls[1][1][11] == tk.ChainLayout(narrow.dims, narrow.low_precision).member_elems


def test_tiles_of_another_stack_or_route_are_refused(fake_card):
    lib = fake_card
    g = torch.Generator().manual_seed(0)
    lv = torch.zeros((1, 18))
    x = torch.zeros((5, 64, 24))
    wide = _stack(WIDE_DIMS["w300"], torch.float32, e=5)
    narrow = _stack((24, 200, 200, 36), torch.float32, e=5)
    for stack, tiles in ((wide, tk.pack_wide(_stack(WIDE_DIMS["w264"], torch.float32, e=5))),
                         (wide, tk.pack_chain(wide)), (narrow, tk.pack_wide(narrow))):
        with pytest.raises(ValueError):
            tk.fused_ensemble_mlp_gaussian(g, x, stack, lv, lv, 18, tiles=tiles)
    assert not lib.calls
    # packed here when none are given, for the route the stack takes
    tk.fused_ensemble_mlp_gaussian(g, x, wide, lv, lv, 18)
    tk.fused_ensemble_mlp_gaussian(g, x, narrow, lv, lv, 18)
    assert [c[0] for c in lib.calls] == ["mbrl_ensemble_mlp_gaussian_wide", "mbrl_ensemble_mlp_gaussian"]
    assert lib.calls[0][1][17] == tk.WideTileLayout(wide.dims, False).member_elems
    assert lib.calls[1][1][16] == tk.ChainLayout(narrow.dims, False).member_elems


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
def test_pack_tiles_follows_the_route(low_precision):
    dtype = torch.bfloat16 if low_precision else torch.float32
    for dims, wide in (((24, 200, 200, 36), False), ((24, 300, 300, 36), True),
                       ((24,) + (64,) * 11 + (36,), True)):
        tiles = tk.pack_tiles(_stack(dims, dtype))
        assert isinstance(tiles.layout, tk.WideTileLayout) == wide
        assert tiles.layout.dims == dims
