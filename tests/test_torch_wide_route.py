"""The kernels' wide route (``csrc/wide_chain.cu``) and the route selection,
on the CPU.

The tensor-core chain takes layers up to 256 wide and 9 products; every other
stack takes the wide route, which reads the ``MLPStack``'s own row-major
weights and keeps a tile's activations in a per-block scratch. These tests
check, without a GPU:

- the route: ``takes_chain`` is true exactly where the chain fits (width and
  depth; K1's obs carry beside the weight ring always fits), and every chain of
  positive widths is supported (264, 300, 512, 1024 wide, 12 products, where
  the wrappers raised before);
- the wide layout: each product's weights and bias sit at ``WideLayout``'s
  offsets of a member's row (the offsets the kernel's running sums reach), and
  the scratch a block needs;
- a plain-torch emulation of the kernel's passes (128 output columns) over
  K chunks (32 rows), with its masks and its bf16 rounding points, against
  ``fused_ensemble_mlp_plain`` and the JAX f32 kernel in interpret mode;
- the wrappers' CUDA branch against a stand-in library: each call reaches the
  entry of its route with arguments that fit the entry's ctypes signature,
  and counts one launch.

Tolerances (|diff| <= atol + rtol |ref|): f32 1e-5 (the emulation sums in
float64, the references in float32: summation order only); bf16 1e-2 (the
same rounding points, but an f32 ulp of difference can flip one bf16
rounding, 2^-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mbrl_tpu.ops import pallas_kernels as pk
from mbrl_tpu_torch.ops import build
from mbrl_tpu_torch.ops import kernels as tk

WIDE_N, WIDE_K = 128, 32  # the kernel's pass width and K chunk (csrc/wide_chain.cu)
WIDE_DIMS = {
    "w264": (24, 264, 264, 36),
    "w300": (24, 300, 300, 36),
    "w512": (24, 512, 512, 36),
    "w1024": (24, 1024, 1024, 36),
    "deep12": (24,) + (64,) * 11 + (36,),  # 12 products
}


def _stack(dims, dtype, seed=0, e=2, activation="silu"):
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy(rng.standard_normal((e, a, b)).astype(np.float32) / np.sqrt(a))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(0.1 * rng.standard_normal((e, 1, b)).astype(np.float32)) for b in dims[1:]]
    return tk.pack_mlp(ws[:-1], bs[:-1], ws[-1], bs[-1], activation, dtype=dtype)


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(WIDE_DIMS))
def test_wide_stacks_are_supported_and_take_the_wide_route(name, low_precision):
    dims = WIDE_DIMS[name]
    assert tk.supports_fused_mlp(dims)
    assert not tk.takes_chain(dims, low_precision)
    # K1 too, whatever its obs carry
    assert not tk.takes_chain(dims, low_precision, 4 * tk.MAX_TILE * 18)


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
def test_the_chain_keeps_what_it_took(low_precision):
    for dims in [(23, 200, 200, 200, 200, 36), (24, 256, 256, 36), (24,) + (64,) * 8 + (36,),
                 (7, 13, 30, 10)]:
        assert tk.takes_chain(dims, low_precision)
    assert not tk.takes_chain((24, 257, 36), low_precision)
    assert not tk.takes_chain((24,) + (64,) * 9 + (36,), low_precision)  # 10 products
    assert not tk.supports_fused_mlp((24,)) and not tk.supports_fused_mlp((24, 0, 36))


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
def test_k1_carry_beside_the_widest_chain_still_fits(low_precision):
    # the widest head the chain takes (256 = 2 x 128) carries 127 obs columns:
    # beside 256-wide f32 activations (128 KB) and two 32 KB chunks it fits
    dims = (127 + 6, 256, 256, 256)
    lay = tk.ChainLayout(dims, low_precision)
    assert lay.stages(4 * tk.MAX_TILE * 128) >= 2
    assert tk.takes_chain(dims, low_precision, 4 * tk.MAX_TILE * 128)


@pytest.mark.parametrize("name", ["w300", "deep12"])
def test_wide_layout_offsets_are_the_stacks_products(name):
    dims = WIDE_DIMS[name]
    stack = _stack(dims, torch.float32, e=3)
    lay = tk.WideLayout(dims)
    assert lay.member_elems == stack.ws.shape[1]
    assert lay.b_offset(stack.num_products) == stack.bs.shape[1]
    for i in range(stack.num_products):
        w, b = stack.product(i)
        k, n = dims[i], dims[i + 1]
        w0, b0 = lay.w_offset(i), lay.b_offset(i)
        assert torch.equal(stack.ws[:, w0 : w0 + k * n].reshape(3, k, n), w)
        assert torch.equal(stack.bs[:, b0 : b0 + n].reshape(3, 1, n), b)
    assert lay.ld == max(dims)
    assert lay.block_floats() == 2 * tk.MAX_TILE * max(dims)
    assert lay.block_floats(carry_dim=17) == 2 * tk.MAX_TILE * max(dims) + tk.MAX_TILE * 18


def _emulated_wide_chain(x: torch.Tensor, stack: tk.MLPStack) -> torch.Tensor:
    """The wide route's arithmetic, pass by pass and chunk by chunk, reading
    each member's weights at the layout's offsets: bf16 stacks round the
    input and every hidden activation; sums in float64."""
    lay, low = tk.WideLayout(stack.dims), stack.low_precision
    act = tk.ACTIVATIONS[stack.activation]

    def rnd(h):
        return h.to(torch.bfloat16).float() if low else h

    outs = []
    for m in range(stack.num_members):
        src = rnd(x[m].float())
        rows = src.shape[0]
        for i in range(stack.num_products):
            k, n = stack.dims[i], stack.dims[i + 1]
            w = stack.ws[m, lay.w_offset(i) : lay.w_offset(i) + k * n].float().reshape(k, n)
            b = stack.bs[m, lay.b_offset(i) : lay.b_offset(i) + n]
            dst = torch.zeros((rows, n))
            for n0 in range(0, n, WIDE_N):
                acc = torch.zeros((rows, WIDE_N), dtype=torch.float64)
                for k0 in range(0, k, WIDE_K):
                    a = F.pad(src[:, k0 : k0 + WIDE_K], (0, WIDE_K - min(WIDE_K, k - k0)))
                    wc = w[k0 : k0 + WIDE_K, n0 : n0 + WIDE_N]
                    wc = F.pad(wc, (0, WIDE_N - wc.shape[1], 0, WIDE_K - wc.shape[0]))
                    acc += a.double() @ wc.double()
                cols = min(WIDE_N, n - n0)
                v = acc[:, :cols].float() + b[n0 : n0 + cols]
                if i + 1 < stack.num_products:
                    v = rnd(act(v))
                dst[:, n0 : n0 + cols] = v
            src = dst
        outs.append(src)
    return torch.stack(outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["w300", "deep12"])
def test_wide_emulation_matches_plain(name, dtype):
    stack = _stack(WIDE_DIMS[name], dtype, seed=3, e=2)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 37, 24)).astype(np.float32))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(_emulated_wide_chain(x, stack), tk.fused_ensemble_mlp_plain(x, stack),
                               rtol=tol, atol=tol)


def test_wide_emulation_matches_the_jax_kernel():
    from mbrl_tpu.models.gaussian_mlp import _ACTIVATIONS

    e, dims = 2, WIDE_DIMS["w300"]
    stack = _stack(dims, torch.float32, seed=5, e=e)
    x = np.random.default_rng(6).standard_normal((e, 16, dims[0])).astype(np.float32)
    layers = [stack.product(i) for i in range(stack.num_products)]
    ref = pk.fused_ensemble_mlp(
        jnp.asarray(x),
        tuple(jnp.asarray(w.numpy()) for w, _ in layers[:-1]),
        tuple(jnp.asarray(b.numpy()) for _, b in layers[:-1]),
        jnp.asarray(layers[-1][0].numpy()), jnp.asarray(layers[-1][1].numpy()),
        activation=_ACTIVATIONS["silu"], tile=8, interpret=True,
    )
    got = _emulated_wide_chain(torch.from_numpy(x), stack).numpy()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=1e-5, atol=1e-5)


class _FakeLibrary:
    """Stands in for the built library: checks each call against its ctypes
    signature (count and conversion) and records the entry's name."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        argtypes = build.SIGNATURES[name]

        def entry(*args):
            assert len(args) == len(argtypes), (name, len(args), len(argtypes))
            for t, a in zip(argtypes, args):
                t.from_param(a)  # raises if the argument does not convert
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, against the stand-in library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(tk, "_dispatch", lambda t: True)
    monkeypatch.setattr(tk, "_stream", lambda device: 0)
    monkeypatch.setattr(tk, "sm_count", lambda device: 132)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


@pytest.mark.parametrize("name", ["w256", "w264", "w512", "w1024", "deep12"])
def test_wrappers_reach_the_entry_of_their_route(fake_card, name):
    dims = (24, 256, 256, 36) if name == "w256" else WIDE_DIMS[name]
    stack = _stack(dims, torch.float32, e=5)
    wide = name != "w256"
    suffix = "_wide" if wide else ""
    g = torch.Generator().manual_seed(0)
    x = torch.zeros((5, 100, 24))
    lv = torch.zeros((1, 18))
    tk.fused_ensemble_mlp(x, stack)
    tk.fused_ensemble_mlp_gaussian(g, x, stack, lv, lv, 18)
    batch, horizon = 640, 3
    obs_dims = (17, 6)  # obs 17 + act 6 = 23 inputs, head 2 x 18
    stack1 = _stack((23,) + dims[1:], torch.float32, e=5)
    tk.fused_rollout_returns(
        g, torch.zeros(horizon, dtype=torch.int32), torch.zeros((batch, obs_dims[0])),
        torch.zeros((batch, horizon, obs_dims[1])), torch.ones((1, 17)), stack1, lv, lv, 18, 64,
    )
    assert [c[0] for c in fake_card.calls] == [
        "mbrl_ensemble_mlp" + suffix, "mbrl_ensemble_mlp_gaussian" + suffix,
        "mbrl_rollout_returns" + suffix,
    ]
    assert tk.launch_counts() == {"fused_rollout_returns": 1, "fused_ensemble_mlp_gaussian": 1,
                                  "fused_ensemble_mlp": 1}
    if wide:  # each scratch holds its grid's blocks: K3 persistent, K2 (tiles, E), K1 tiles
        lay = tk.WideLayout(dims)
        grids = [tk.persistent_blocks(100, 5, 132), 2 * 5]
        for (_, args), blocks in zip(fake_card.calls[:2], grids):
            assert args[-2] == blocks * lay.block_floats()
        assert fake_card.calls[2][1][-2] == (batch // 64) * tk.WideLayout(stack1.dims).block_floats(17)
        # the device dims hold the stack's dims
        assert tk._device_dims(dims, torch.device("cpu")).tolist() == list(dims)


def test_wide_wrappers_raise_only_for_what_no_route_takes(fake_card):
    x = torch.zeros((2, 8, 24))
    with pytest.raises(TypeError):  # weights of another dtype
        stack = _stack(WIDE_DIMS["w300"], torch.float32)
        tk.fused_ensemble_mlp(x, tk.MLPStack(stack.ws.double(), stack.bs, stack.dims, "silu"))
    with pytest.raises(ValueError):  # a stack that does not match its dims
        stack = _stack(WIDE_DIMS["w300"], torch.float32)
        tk.fused_ensemble_mlp(x, tk.MLPStack(stack.ws[:, 1:].contiguous(), stack.bs, stack.dims, "silu"))
    assert not fake_card.calls
