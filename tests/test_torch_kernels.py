"""The port's kernel wrappers (mbrl_tpu_torch/ops/kernels.py) on CPU tensors,
i.e. their plain PyTorch versions, against the JAX package's Pallas kernels
run in interpret mode (mean path, as tests/test_pallas.py runs them).

Tolerances: f32 1e-4 (float-sum order, as tests/test_pallas.py:180); bf16
weight stacks 2e-2 (bf16 rounds at the same points in both)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbrl_tpu.ops import pallas_kernels as pk
from mbrl_tpu_torch.ops import kernels as tk

E, IN, HID, D, A = 3, 7, 16, 5, 2
OUT = D + 1
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _weights(seed, in_size=IN, out=2 * OUT, num_layers=2, scale=0.2):
    rng = np.random.default_rng(seed)
    dims = [in_size] + [HID] * num_layers
    ws = [scale * rng.standard_normal((E, dims[i], dims[i + 1])).astype(np.float32)
          for i in range(num_layers)]
    bs = [scale * rng.standard_normal((E, 1, HID)).astype(np.float32) for _ in range(num_layers)]
    hw = scale * rng.standard_normal((E, HID, out)).astype(np.float32)
    hb = scale * rng.standard_normal((E, 1, out)).astype(np.float32)
    return ws, bs, hw, hb


def _jax_weights(ws, bs, hw, hb, dtype):
    jdt = jnp.dtype(dtype)
    return (
        tuple(jnp.asarray(w).astype(jdt) for w in ws),
        tuple(jnp.asarray(b) for b in bs),
        jnp.asarray(hw).astype(jdt),
        jnp.asarray(hb),
    )


def _stack(ws, bs, hw, hb, dtype, activation="silu"):
    t = torch.from_numpy
    return tk.pack_mlp([t(w) for w in ws], [t(b) for b in bs], t(hw), t(hb), activation,
                       dtype=getattr(torch, dtype))


def _bounds():
    return 0.5 * np.ones((1, OUT), np.float32), -10.0 * np.ones((1, OUT), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "activation", ["relu", "silu", "swish", "tanh", "elu", "gelu", "leaky_relu"]
)
def test_k3_plain_matches_jax_kernel(dtype, activation):
    from mbrl_tpu.models.gaussian_mlp import _ACTIVATIONS

    ws, bs, hw, hb = _weights(0)
    x = np.random.default_rng(1).standard_normal((E, 16, IN)).astype(np.float32)
    ref = pk.fused_ensemble_mlp(
        jnp.asarray(x).astype(jnp.dtype(dtype)), *_jax_weights(ws, bs, hw, hb, dtype),
        activation=_ACTIVATIONS[activation], tile=8, interpret=True,
    )
    got = tk.fused_ensemble_mlp(torch.from_numpy(x), _stack(ws, bs, hw, hb, dtype, activation))
    assert got.shape == (E, 16, 2 * OUT) and got.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_mean_matches_jax_kernel(dtype):
    ws, bs, hw, hb = _weights(2)
    maxlv, minlv = _bounds()
    x = np.random.default_rng(3).standard_normal((E, 24, IN)).astype(np.float32)
    ref = pk.fused_ensemble_mlp_gaussian(
        jnp.array([123, 456], jnp.int32), jnp.asarray(x).astype(jnp.dtype(dtype)),
        *_jax_weights(ws, bs, hw, hb, dtype), jnp.asarray(maxlv), jnp.asarray(minlv),
        out_size=OUT, tile=8, sample=False, interpret=True,
    )
    got = tk.fused_ensemble_mlp_gaussian(
        torch.Generator().manual_seed(0), torch.from_numpy(x), _stack(ws, bs, hw, hb, dtype),
        torch.from_numpy(maxlv), torch.from_numpy(minlv), OUT, sample=False,
    )
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_k2_plain_samples_bounded_gaussian():
    """sample=True draws mean + exp(logvar/2) * N(0, 1) around the JAX mean."""
    ws, bs, hw, hb = _weights(4)
    maxlv, minlv = _bounds()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((E, 2000, IN)).astype(np.float32))
    stack = _stack(ws, bs, hw, hb, "float32")
    g = torch.Generator().manual_seed(0)
    args = (x, stack, torch.from_numpy(maxlv), torch.from_numpy(minlv), OUT)
    mean = tk.fused_ensemble_mlp_gaussian(g, *args, sample=False)
    draw = tk.fused_ensemble_mlp_gaussian(g, *args, sample=True)
    raw = tk.fused_ensemble_mlp(x, stack)
    sigma = torch.exp(0.5 * tk.bound_logvar(raw[..., OUT:], args[2], args[3]))
    z = ((draw - mean) / sigma).double()
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n**0.5
    assert abs(float(z.var()) - 1.0) < 5 * (2 / n) ** 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_matches_jax_kernel(dtype):
    """Same tile, rot and delta mask (dim 1 is not a delta) in both."""
    e, tile, horizon, batch = 2, 8, 4, 32  # 4 tiles, 2 per member
    rng = np.random.default_rng(6)
    dims_in = D + A
    ws = [0.2 * rng.standard_normal((e, dims_in, HID)).astype(np.float32),
          0.2 * rng.standard_normal((e, HID, HID)).astype(np.float32)]
    bs = [0.2 * rng.standard_normal((e, 1, HID)).astype(np.float32) for _ in range(2)]
    hw = 0.2 * rng.standard_normal((e, HID, 2 * OUT)).astype(np.float32)
    hb = 0.2 * rng.standard_normal((e, 1, 2 * OUT)).astype(np.float32)
    maxlv, minlv = _bounds()
    obs0 = rng.standard_normal((batch, D)).astype(np.float32)
    acts = rng.standard_normal((batch, horizon, A)).astype(np.float32)
    rot = np.array([0, 3, 1, 2], np.int32)
    dmask = np.ones((1, D), np.float32)
    dmask[0, 1] = 0.0
    ref = pk.fused_rollout_returns(
        jnp.array([7, 8], jnp.int32), jnp.asarray(rot), jnp.asarray(obs0), jnp.asarray(acts),
        jnp.asarray(dmask), *_jax_weights(ws, bs, hw, hb, dtype), jnp.asarray(maxlv),
        jnp.asarray(minlv), out_size=OUT, tile=tile, sample=False, interpret=True,
    )
    t = torch.from_numpy
    got = tk.fused_rollout_returns(
        torch.Generator().manual_seed(0), t(rot), t(obs0), t(acts), t(dmask),
        _stack(ws, bs, hw, hb, dtype), t(maxlv), t(minlv), OUT, tile, sample=False,
    )
    assert got.shape == (batch, 1)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_k1_plain_rejects_bad_tile():
    ws, bs, hw, hb = _weights(7, in_size=D + A)
    maxlv, minlv = _bounds()
    with pytest.raises(ValueError):
        tk.fused_rollout_returns(
            torch.Generator(), torch.zeros(2, dtype=torch.int32), torch.zeros((30, D)),
            torch.zeros((30, 2, A)), torch.ones((1, D)), _stack(ws, bs, hw, hb, "float32"),
            torch.from_numpy(maxlv), torch.from_numpy(minlv), OUT, tile=8,
        )


def test_pack_mlp_layout_and_views():
    ws, bs, hw, hb = _weights(8)
    stack = _stack(ws, bs, hw, hb, "float32")
    assert stack.dims == (IN, HID, HID, 2 * OUT) and stack.num_products == 3
    for i, (w, b) in enumerate(zip(ws + [hw], bs + [hb])):
        wv, bv = stack.product(i)
        np.testing.assert_array_equal(wv.numpy(), w)
        np.testing.assert_array_equal(bv.numpy(), b)
    low = _stack(ws, bs, hw, hb, "bfloat16")
    assert low.low_precision and low.ws.dtype == torch.bfloat16 and low.bs.dtype == torch.float32


def test_pick_tile_and_supports():
    assert tk.pick_tile(1600) == 64
    assert tk.pick_tile(160) == 40
    assert tk.pick_tile(16) == 16
    assert tk.pick_tile(7) is None  # no divisor in [8, 64]
    assert tk.supports_fused_mlp((24, 200, 200, 200, 200, 36))
    assert tk.takes_chain((24, 200, 200, 200, 200, 36), False)
    # 300 columns: supported, by the wide route
    assert tk.supports_fused_mlp((24, 300, 36)) and not tk.takes_chain((24, 300, 36), False)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA device is refused, not computed."""
    ws, bs, hw, hb = _weights(9)
    x = torch.zeros((E, 8, IN), device="meta")
    with pytest.raises(ValueError):
        tk.fused_ensemble_mlp(x, _stack(ws, bs, hw, hb, "float32"))


def test_launch_counters_count_only_kernel_launches():
    ws, bs, hw, hb = _weights(10)
    tk.reset_launch_counts()
    tk.fused_ensemble_mlp(torch.zeros((E, 8, IN)), _stack(ws, bs, hw, hb, "float32"))
    assert tk.launch_counts() == {
        "fused_rollout_returns": 0, "fused_ensemble_mlp_gaussian": 0, "fused_ensemble_mlp": 0,
        "fused_ensemble_mlp.tile": 0, "fused_ensemble_mlp.pair": 0,
        "fused_ensemble_mlp.cluster": 0, "fused_ensemble_mlp.scratch": 0,
        "fused_ensemble_mlp.smem": 0, "fused_ensemble_mlp.fused_head": 0,
        "_forward_sharded.glue": 0, "fused_policy_mlp": 0, "fused_policy_mlp.repacks": 0,
        "fused_policy_mlp.linear": 0,
    }
