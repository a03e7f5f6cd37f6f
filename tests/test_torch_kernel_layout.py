"""K1/K2's weight layout (``pack_chain``) and their f32 numbers, on the CPU.

The tensor-core kernels read each product's weights as chunks in ``wgmma``'s
shared-memory layout; for an f32 stack, as two tf32 copies (hi, lo) for
3xTF32 products. These tests check, without a GPU:

- the layout round-trips exactly (bf16 weights; f32 hi/lo copies), every pad
  is zero, and single elements sit where the kernel's descriptors look;
- the tf32 split: hi keeps 10 mantissa bits, rounded to nearest with ties away
  from zero as ``cvt.rna.tf32.f32``, and hi + lo is within 2^-21 relative of w;
- a plain-torch emulation of the 3xTF32 chain (a_hi w_hi + a_hi w_lo + a_lo w_hi
  on the packed tf32 values, rounding done on the bits, the accumulator sets
  and the head's split by K summed in the kernels' order) against the JAX f32
  kernel in interpret mode and against ``fused_ensemble_mlp_plain``;
- the shared-memory plan of a head split by K and of K1's and K2's normals.

Tolerance of the emulation, 1e-5 (|diff| <= atol + rtol |ref|): 3xTF32 drops
a_lo w_lo and rounds lo to tf32, ~2^-22 relative per product term; over a
4-product chain at unit-scale activations that is ~1e-6, well inside 1e-5,
while plain TF32 (~2^-11) would miss it by two orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mbrl_tpu.ops import pallas_kernels as pk
from mbrl_tpu_torch.ops import kernels as tk

MAIN_DIMS = [(23, 200, 200, 200, 200, 36), (24, 200, 200, 200, 200, 36)]
DET_DIMS = (24, 200, 200, 200, 200, 18)  # a deterministic model's head: out, not 2 * out
RAGGED_DIMS = (7, 13, 30, 10)  # no width a multiple of 8
WIDEST_DIMS = (24, 256, 256, 36)  # the widest layer the tensor-core chain takes


def _stack(dims, dtype, seed=0, e=2, activation="silu"):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy(rng.standard_normal((e, a, b)).astype(np.float32) / np.sqrt(a))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(0.1 * rng.standard_normal((e, 1, b)).astype(np.float32)) for b in dims[1:]]
    return tk.pack_mlp(ws[:-1], bs[:-1], ws[-1], bs[-1], activation, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dims", MAIN_DIMS + [RAGGED_DIMS, DET_DIMS, WIDEST_DIMS],
                         ids=["main23", "main24", "ragged", "head18", "widest"])
def test_layout_round_trips_with_zero_pads(dims, dtype):
    stack = _stack(dims, dtype)
    tiles = tk.pack_chain(stack)
    lay = tiles.layout
    assert tiles.w.dtype == dtype and tiles.w.shape == (stack.num_members, lay.member_elems)
    for i in range(stack.num_products):
        w, _ = stack.product(i)
        k, n = w.shape[1:]
        copies = tk.unpack_chain(tiles, i)
        assert all(c.shape == (stack.num_members, lay.k_pad[i], lay.n_pad[i]) for c in copies)
        if dtype == torch.bfloat16:
            expect = [w]
        else:
            hi = tk.rna_tf32(w)
            expect = [hi, tk.rna_tf32(w - hi)]
        for got, want in zip(copies, expect):
            assert torch.equal(got[:, :k, :n], want)
            assert not got[:, k:, :].any() and not got[:, :, n:].any()


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
def test_main_shapes_pad_to_the_instruction(low_precision):
    lay = tk.ChainLayout((23, 200, 200, 200, 200, 36), low_precision)
    if low_precision:  # K to the bf16 depth 16, N to the next K, the head to 8
        assert lay.k_pad == (32, 208, 208, 208, 208)
        assert lay.n_pad == (208, 208, 208, 208, 40)
    else:  # K to the tf32 depth 8
        assert lay.k_pad == (24, 200, 200, 200, 200)
        assert lay.n_pad == (200, 200, 200, 200, 40)
    # K1's shared-memory plan (obs carry of 17) leaves room for the ring,
    # also with its two buffers of a step's normals; so does K2's
    assert lay.stages(4 * tk.MAX_TILE * 18) >= 2
    assert lay.stages(tk.k1_extra_bytes(17, 18)) >= 2 and lay.stages(tk.k2_extra_bytes(18)) >= 2
    assert lay.head_split  # a 40-column head is split by K over the warpgroups


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
def test_deterministic_head_pads_to_24_columns(low_precision):
    """Head 18 is padded to 24 columns (three 8-column groups, all taken by
    each warpgroup: the head is split by K), and the two partial head tiles
    fit the activation region."""
    lay = tk.ChainLayout(DET_DIMS, low_precision)
    assert lay.n_pad[-1] == 24 and lay.n_pad[:-1] == lay.k_pad[1:]
    assert lay.head_split and lay.stages() >= 2
    assert 2 * tk.MAX_TILE * lay.n_pad[-1] * 4 <= lay.copies * tk.MAX_TILE * max(lay.k_pad) * lay.esize


def _smem_plan(dims, low_precision, extra):
    """make_chain_desc's plan, written out: barriers, the activation region
    (or the head's tiles, two if split by K), the logvar bounds, ``extra``,
    and as many ring buffers of the largest chunk as fit (at most 4)."""
    esize, copies, step, chunk = (2, 1, 16, 64) if low_precision else (4, 2, 8, 16)
    kp = [-(-d // step) * step for d in dims[:-1]]
    np_ = kp[1:] + [-(-dims[-1] // 8) * 8]
    head = 64 * np_[-1] * 4 * (2 if np_[-1] <= 40 else 1)
    a = -(-max(copies * 64 * max(kp) * esize, head) // 128) * 128
    stage = max(min(chunk, k) * n * esize * copies for k, n in zip(kp, np_))
    return min(4, (232_448 - 128 - 1024 - a - extra) // stage)


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("dims", [(8, 16, 40), (8, 16, 48), (5, 200, 8), (24, 256, 256, 36),
                                  (24, 256, 256, 256), (23, 256, 256, 254), (7, 13, 30, 10)],
                         ids=["split40", "n48", "head8", "widest36", "head256", "k1_254",
                              "ragged"])
def test_head_split_and_normals_in_the_shared_memory_plan(dims, low_precision):
    """A head of at most TC_HEAD_SPLIT (padded) columns is split by K and
    takes two tiles; K2's normals and K1's carry and two buffers of normals
    come out of the ring's room, as make_chain_desc plans it."""
    lay = tk.ChainLayout(dims, low_precision)
    assert lay.head_split == (lay.n_pad[-1] <= tk.TC_HEAD_SPLIT)
    out = dims[-1] // 2
    for extra in (0, tk.k2_extra_bytes(out), tk.k1_extra_bytes(out - 1, out)):
        assert lay.stages(extra) == _smem_plan(dims, low_precision, extra)
        assert tk.takes_chain(dims, low_precision, extra) == (lay.stages(extra) >= 2)
    # at 256 columns in f32 K1's normals leave too little room: the wide route
    if dims == (23, 256, 256, 254) and not low_precision:
        assert tk.takes_chain(dims, False, 4 * tk.MAX_TILE * 128)
        assert not tk.takes_chain(dims, False, tk.k1_extra_bytes(126, 127))


@pytest.mark.parametrize("dtype,k_rows,scale", [(torch.float32, 40, 32), (torch.bfloat16, 15, 16)],
                         ids=["f32", "bf16"])
def test_elements_sit_where_the_descriptors_read(dtype, k_rows, scale):
    """w[k, n] = k * scale + n, exact in the type (f32's 40 rows span three
    chunks), found at product_offset + chunk_offset
    + ((k//t * n_pad/8 + n//8) * 8 + n%8) * t + k%t of the first copy."""
    w0 = (torch.arange(float(k_rows))[:, None] * scale + torch.arange(12.0)[None, :])[None]
    w1 = (torch.arange(12.0)[:, None] * scale + torch.arange(6.0)[None, :])[None]
    stack = tk.pack_mlp([w0], [torch.zeros(1, 1, 12)], w1, torch.zeros(1, 1, 6), "relu", dtype=dtype)
    tiles = tk.pack_chain(stack)
    lay = tiles.layout
    flat = tiles.w[0].float()
    for i, w in enumerate((w0, w1)):
        kp, np_, t = lay.k_pad[i], lay.n_pad[i], lay.t
        for k in range(w.shape[1]):
            for n in range(w.shape[2]):
                c0 = k // lay.chunk * lay.chunk  # the chunk holding row k
                kc = min(lay.chunk, kp - c0)
                off = lay.product_offset(i) + c0 * np_ * lay.copies
                kk = k - c0
                pos = off + ((kk // t * (np_ // 8) + n // 8) * 8 + n % 8) * t + kk % t
                assert float(flat[pos]) == float(w[0, k, n]), (i, k, n)
                assert kc * np_ * lay.copies * lay.esize % 16 == 0  # one bulk copy: 16-byte multiple


def test_tf32_split():
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.standard_normal(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000))
                         .astype(np.float32))
    hi = tk.rna_tf32(w)
    lo = tk.rna_tf32(w - hi)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # 13 low mantissa bits zero
    rel = ((hi.double() + lo.double() - w.double()).abs() / w.double().abs()).max()
    assert float(rel) <= 2.0**-21
    # ties go away from zero, like cvt.rna: exactly half of the dropped ulp
    tie = torch.tensor([0x3F801000, -0x407FF000], dtype=torch.int32).view(torch.float32)
    assert tk.rna_tf32(tie).view(torch.int32).tolist() == [0x3F802000, -0x407FE000]


def _kernel_sum(a_hi, a_lo, w_hi, w_lo, b, split: bool):
    """One product as the f32 chain sums it. Each wgmma (k-step g of 8 rows,
    3xTF32 term t: a_lo w_hi, a_hi w_lo, a_hi w_hi) adds its exact product
    to the accumulators, rounded to f32 at the end, then the bias is added.
    Split by K (a narrow head; chunks of two k-steps): warpgroup g % 2 takes
    k-step g on accumulators of its own, warpgroup 0 adds the bias, and the
    head is warpgroup 0's tile + warpgroup 1's."""
    terms = ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi))
    parts = {}
    for g in range(w_hi.shape[-2] // 8):
        rows = slice(8 * g, 8 * g + 8)
        for t, (a, w) in enumerate(terms):
            key = (g % 2, 0) if split else (0, 0)
            parts[key] = parts.get(key, 0) + a[..., rows] @ w[..., rows, :]
    total = None
    for wg in range(2 if split else 1):
        part = torch.zeros_like(parts[(0, 0)], dtype=torch.float32)
        for k, s in enumerate(sorted(k for k in parts if k[0] == wg)):
            part = parts[s].float() if k == 0 else part + parts[s].float()
        part = part + b if wg == 0 else part
        total = part if total is None else total + part
    return total


def _emulated_3xtf32_chain(x: torch.Tensor, stack: tk.MLPStack) -> torch.Tensor:
    """The f32 kernels' arithmetic in plain torch: each product as
    a_hi w_hi + a_hi w_lo + a_lo w_hi on the packed tf32 copies (exact
    products), summed in the kernels' order with the bias
    (:func:`_kernel_sum`), then the activation in f32."""
    tiles = tk.pack_chain(stack)
    act = tk.ACTIVATIONS[stack.activation]
    h = x.float()
    for i in range(stack.num_products):
        w_hi, w_lo = (c.double() for c in tk.unpack_chain(tiles, i))
        _, b = stack.product(i)
        a = F.pad(h, (0, tiles.layout.k_pad[i] - h.shape[-1]))
        a_hi = tk.rna_tf32(a)
        a_lo = tk.rna_tf32(a - a_hi)
        head = i == stack.num_products - 1
        b = F.pad(b, (0, tiles.layout.n_pad[i] - b.shape[-1]))
        out = _kernel_sum(a_hi.double(), a_lo.double(), w_hi, w_lo, b,
                          head and tiles.layout.head_split)[..., : stack.dims[i + 1]]
        h = out if head else act(out)
    return h


@pytest.mark.parametrize("head", [36, 18], ids=["gaussian", "deterministic"])
@pytest.mark.parametrize("activation", ["silu", "tanh", "relu"])
def test_3xtf32_emulation_matches_jax_kernel_and_plain(activation, head):
    from mbrl_tpu.models.gaussian_mlp import _ACTIVATIONS

    e, dims = 3, (24, 64, 64, 64, head)
    stack = _stack(dims, torch.float32, seed=5, e=e, activation=activation)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((e, 16, dims[0])).astype(np.float32)
    got = _emulated_3xtf32_chain(torch.from_numpy(x), stack).numpy()
    layers = [stack.product(i) for i in range(stack.num_products)]
    ref_jax = pk.fused_ensemble_mlp(
        jnp.asarray(x),
        tuple(jnp.asarray(w.numpy()) for w, _ in layers[:-1]),
        tuple(jnp.asarray(b.numpy()) for _, b in layers[:-1]),
        jnp.asarray(layers[-1][0].numpy()), jnp.asarray(layers[-1][1].numpy()),
        activation=_ACTIVATIONS[activation], tile=8, interpret=True,
    )
    ref_plain = tk.fused_ensemble_mlp_plain(torch.from_numpy(x), stack).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_jax, np.float32), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref_plain, rtol=1e-5, atol=1e-5)


def test_plain_tf32_would_not_pass():
    """The tolerance above tells 3xTF32 from plain TF32: one tf32 product
    per layer misses 1e-5 on the same chain."""
    e, dims = 3, (24, 64, 64, 64, 36)
    stack = _stack(dims, torch.float32, seed=5, e=e)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((e, 16, dims[0])).astype(np.float32))
    h = x
    for i in range(stack.num_products):
        w, b = stack.product(i)
        h = (tk.rna_tf32(h).double() @ tk.rna_tf32(w).double()).float() + b
        h = F.silu(h) if i < stack.num_products - 1 else h
    err = (h - tk.fused_ensemble_mlp_plain(x, stack)).abs().max()
    assert float(err) > 1e-4


def test_tensor_core_wrappers_refuse_what_they_cannot_take():
    cpu = torch.device("cpu")
    stack = _stack((24, 200, 36), torch.float32)
    tiles = tk._check_tiles(stack, None, cpu)  # packs when not given
    assert tiles.layout == tk.ChainLayout((24, 200, 36), False)
    # wider than the wgmma slots: the chain is not asked, the wide route takes it
    assert not tk.takes_chain((24, 264, 36), False)
    with pytest.raises(ValueError):  # tiles of another stack
        tk._check_tiles(_stack((24, 64, 36), torch.float32), tiles, cpu)
    with pytest.raises(ValueError):  # the bf16 layout of the same dims
        tk._check_tiles(stack, tk.pack_chain(_stack((24, 200, 36), torch.bfloat16)), cpu)
    with pytest.raises(TypeError):  # the right layout in the wrong dtype
        tk._check_tiles(stack, tk.ChainTiles(tiles.w.to(torch.bfloat16), tiles.layout), cpu)


# --------------------------------------------------------------------------- #
# K3's two-tile and cluster routes (csrc/ensemble_mlp.cu)
# --------------------------------------------------------------------------- #
_WIDTHS = (1, 5, 8, 13, 16, 24, 36, 100, 200, 208, 255, 256)


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("depth", [1, 2, 5, 9])
def test_pair_and_cluster_plans_fit_wherever_the_chain_does(depth, low_precision):
    """Every stack the chain takes (``takes_chain``: up to 9 products, widths
    up to 256) fits the two-tile route's plan (two warpgroups' A, their
    biases and at least two ring buffers) and the cluster route's (two
    activation buffers of 64 rows and the k-slices' partial sums) in one
    block's 232,448 bytes, so neither route sends a stack elsewhere."""
    for hid in _WIDTHS:
        for edge in (1, 36, 256):
            dims = (edge,) + (hid,) * (depth - 1) + (edge,)
            assert tk.takes_chain(dims, low_precision)
            lay = tk.ChainLayout(dims, low_precision)
            assert lay.pair_stages >= 2
            assert lay.pair_smem_bytes <= tk.TC_SMEM_BYTES
            assert tk.cluster_smem_bytes(dims, tk.MAX_TILE) <= tk.TC_SMEM_BYTES


@pytest.mark.parametrize("low_precision,stages", [(False, 4), (True, 6)], ids=["f32", "bf16"])
def test_pair_plan_at_the_main_shape(low_precision, stages):
    """At 4x200 (f32 A 51.2 KB a warpgroup, bf16 26.6 KB, one copy each),
    the ring keeps 4 f32 or 6 bf16 buffers; f32's hi and lo copies of two
    tiles would leave room for none."""
    lay = tk.ChainLayout((23, 200, 200, 200, 200, 36), low_precision)
    assert lay.pair_a_bytes == (26_624 if low_precision else 51_200)
    assert lay.pair_stages == stages
    if not low_precision:
        assert 2 * 2 * 64 * 200 * 4 + 2 * lay.stage_bytes > tk.TC_SMEM_BYTES


def _slot(q: int, warp: int, lane: int) -> int:
    """pair_slot: byte offset of a lane's 16-byte A fragment slot."""
    return ((q * 4 + warp) * 32 + (lane ^ ((lane >> 2) & 2))) * 16


def _pair_fragments(a: np.ndarray, low_precision: bool):
    """A (64, K) tile through the two-tile route's shared memory: stored as
    pair_store leaves a product's D fragment (or the input tile), read back
    as pair_fragment gathers each lane's A fragment. Returns {(q, warp, lane):
    four values} in register order (bf16: the (lo, hi) pairs, unpacked)."""
    kstep = 16 if low_precision else 8
    region = {}
    for q in range(a.shape[1] // kstep):
        for warp in range(4):
            for lane in range(32):
                r, c = 16 * warp + lane // 4, kstep * q + 2 * (lane % 4)
                if low_precision:  # the fragment itself
                    vals = [a[r, c], a[r, c + 1], a[r + 8, c], a[r + 8, c + 1],
                            a[r, c + 8], a[r, c + 9], a[r + 8, c + 8], a[r + 8, c + 9]]
                else:  # (r, c), (r + 8, c), (r, c + 1), (r + 8, c + 1)
                    vals = [a[r, c], a[r + 8, c], a[r, c + 1], a[r + 8, c + 1]]
                assert _slot(q, warp, lane) not in region
                region[_slot(q, warp, lane)] = vals
    frags = {}
    for (q, warp, lane) in [(q, w, l) for q in range(a.shape[1] // kstep) for w in range(4)
                            for l in range(32)]:
        if low_precision:
            frags[q, warp, lane] = region[_slot(q, warp, lane)]
        else:
            t, g4 = lane % 4, lane & ~3
            p = region[_slot(q, warp, g4 + t // 2)][2 * (t & 1): 2 * (t & 1) + 2]
            s = region[_slot(q, warp, g4 + 2 + t // 2)][2 * (t & 1): 2 * (t & 1) + 2]
            frags[q, warp, lane] = p + s
    return frags


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
def test_pair_fragments_are_wgmma_register_operands(low_precision):
    """Each lane's fragment holds the A elements that wgmma's register
    operand takes (PTX's m64nNk8 tf32 and m64nNk16 bf16 A fragments: warp w
    rows 16w + g and + 8, g = lane / 4; tf32 columns t and t + 4, bf16
    column pairs 2t and 2t + 8, t = lane % 4), and the swizzled slots hit no
    shared-memory bank twice within a phase: the f32 8-byte reads (16
    lanes) and the 16-byte stores (8 lanes)."""
    k = 48 if low_precision else 40
    a = np.arange(64 * k, dtype=np.float64).reshape(64, k)
    for (q, warp, lane), got in _pair_fragments(a, low_precision).items():
        r, t = 16 * warp + lane // 4, lane % 4
        if low_precision:
            c = 16 * q + 2 * t
            want = [a[r, c], a[r, c + 1], a[r + 8, c], a[r + 8, c + 1],
                    a[r, c + 8], a[r, c + 9], a[r + 8, c + 8], a[r + 8, c + 9]]
        else:
            c = 8 * q + t
            want = [a[r, c], a[r + 8, c], a[r, c + 4], a[r + 8, c + 4]]
        assert got == want, (q, warp, lane)
    for q, warp in [(0, 0), (3, 2)]:
        for half in (0, 16):  # 8-byte reads of lanes 4g + t/2 (+ 2), words 2(t % 2)..
            for second in (0, 2):
                banks = set()
                for lane in range(half, half + 16):
                    t, g4 = lane % 4, lane & ~3
                    word = (_slot(q, warp, g4 + second + t // 2) + 8 * (t & 1)) // 4
                    banks |= {word % 32, (word + 1) % 32}
                assert len(banks) == 32
        for quarter in range(0, 32, 8):  # 16-byte stores of 8 lanes
            banks = {(_slot(q, warp, lane) // 4 + i) % 32 for lane in range(quarter, quarter + 8)
                     for i in range(4)}
            assert len(banks) == 32


def _emulated_pair_chain(x: torch.Tensor, stack: tk.MLPStack) -> torch.Tensor:
    """The f32 two-tile route's arithmetic in plain torch: each product's A
    as the route holds it (f32 in shared memory, gathered by fragment and
    split into tf32 hi and lo in registers), its three products a k-step at a
    time on one accumulator of the full width (a head is not split by K),
    the bias added in the epilogue."""
    tiles = tk.pack_chain(stack)
    act = tk.ACTIVATIONS[stack.activation]
    h = x.float()
    for i in range(stack.num_products):
        w_hi, w_lo = (c.double() for c in tk.unpack_chain(tiles, i))
        _, b = stack.product(i)
        kp = tiles.layout.k_pad[i]
        a = F.pad(h, (0, kp - h.shape[-1]))
        gathered = torch.zeros_like(a)
        for e in range(a.shape[0]):
            for r0 in range(0, a.shape[1], 64):
                tile = np.zeros((64, kp), np.float32)
                rows = a[e, r0:r0 + 64].numpy()
                tile[: rows.shape[0]] = rows
                back = np.zeros_like(tile)
                for (q, warp, lane), (v0, v1, v2, v3) in _pair_fragments(tile, False).items():
                    rr, c = 16 * warp + lane // 4, 8 * q + lane % 4
                    back[rr, c], back[rr + 8, c], back[rr, c + 4], back[rr + 8, c + 4] = v0, v1, v2, v3
                gathered[e, r0:r0 + 64] = torch.from_numpy(back[: rows.shape[0]])
        a_hi = tk.rna_tf32(gathered)
        a_lo = tk.rna_tf32(gathered - a_hi)
        b = F.pad(b, (0, tiles.layout.n_pad[i] - b.shape[-1]))
        out = _kernel_sum(a_hi.double(), a_lo.double(), w_hi, w_lo, b, False)[..., : stack.dims[i + 1]]
        h = out if i == stack.num_products - 1 else act(out)
    return h


@pytest.mark.parametrize("activation", ["silu", "tanh"])
def test_pair_route_emulation_matches_jax_kernel_and_plain(activation):
    """The register-A 3xTF32 split of the two-tile route against the JAX f32
    kernel in interpret mode and the plain version, within 1e-5 (as
    test_3xtf32_emulation_matches_jax_kernel_and_plain): a ragged second
    tile (70 rows a member) and a narrow head, which this route does not
    split by K."""
    from mbrl_tpu.models.gaussian_mlp import _ACTIVATIONS

    e, dims = 2, (24, 64, 64, 36)
    stack = _stack(dims, torch.float32, seed=7, e=e, activation=activation)
    x = np.random.default_rng(8).standard_normal((e, 70, dims[0])).astype(np.float32)
    got = _emulated_pair_chain(torch.from_numpy(x), stack).numpy()
    layers = [stack.product(i) for i in range(stack.num_products)]
    ref_jax = pk.fused_ensemble_mlp(
        jnp.asarray(x),
        tuple(jnp.asarray(w.numpy()) for w, _ in layers[:-1]),
        tuple(jnp.asarray(b.numpy()) for _, b in layers[:-1]),
        jnp.asarray(layers[-1][0].numpy()), jnp.asarray(layers[-1][1].numpy()),
        activation=_ACTIVATIONS[activation], tile=14, interpret=True,
    )
    ref_plain = tk.fused_ensemble_mlp_plain(torch.from_numpy(x), stack).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_jax, np.float32), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref_plain, rtol=1e-5, atol=1e-5)
