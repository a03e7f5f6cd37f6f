"""K1/K2's weight layout (``pack_chain``) and their f32 numbers, on the CPU.

The tensor-core kernels read each product's weights as chunks in ``wgmma``'s
shared-memory layout; for an f32 stack, as two tf32 copies (hi, lo) for
3xTF32 products. These tests check, without a GPU:

- the layout round-trips exactly (bf16 weights; f32 hi/lo copies), every pad
  is zero, and single elements sit where the kernel's descriptors look;
- the tf32 split: hi keeps 10 mantissa bits, rounded to nearest with ties away
  from zero as ``cvt.rna.tf32.f32``, and hi + lo is within 2^-21 relative of w;
- a plain-torch emulation of the 3xTF32 chain (a_hi w_hi + a_hi w_lo + a_lo w_hi
  on the packed tf32 values, rounding done on the bits) against the JAX f32
  kernel in interpret mode and against ``fused_ensemble_mlp_plain``.

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
    # K1's shared-memory plan (obs carry of 17) leaves room for the ring
    assert lay.stages(4 * tk.MAX_TILE * 18) >= 2


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
def test_deterministic_head_pads_to_24_columns(low_precision):
    """Head 18 is padded to 24 columns (three 8-column groups, split 2 + 1
    between the warpgroups), and the head tile fits the activation region."""
    lay = tk.ChainLayout(DET_DIMS, low_precision)
    assert lay.n_pad[-1] == 24 and lay.n_pad[:-1] == lay.k_pad[1:]
    assert lay.stages() >= 2
    assert tk.MAX_TILE * lay.n_pad[-1] * 4 <= lay.copies * tk.MAX_TILE * max(lay.k_pad) * lay.esize


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


def _emulated_3xtf32_chain(x: torch.Tensor, stack: tk.MLPStack) -> torch.Tensor:
    """The f32 kernels' arithmetic in plain torch: each product as
    a_hi w_hi + a_hi w_lo + a_lo w_hi on the packed tf32 copies (exact
    products, summed in f64), then bias and activation in f32."""
    tiles = tk.pack_chain(stack)
    act = tk.ACTIVATIONS[stack.activation]
    h = x.float()
    for i in range(stack.num_products):
        w_hi, w_lo = (c.double() for c in tk.unpack_chain(tiles, i))
        _, b = stack.product(i)
        a = F.pad(h, (0, tiles.layout.k_pad[i] - h.shape[-1]))
        a_hi = tk.rna_tf32(a)
        a_lo = tk.rna_tf32(a - a_hi)
        a_hi, a_lo = a_hi.double(), a_lo.double()
        out = (a_hi @ w_hi + a_hi @ w_lo + a_lo @ w_hi).float()[..., : stack.dims[i + 1]] + b
        h = act(out) if i < stack.num_products - 1 else out
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
