"""The kernels' wide route and the route selection, on the CPU.

The tensor-core chain takes layers up to 256 wide and 9 products; every other
stack takes the wide route, which keeps a tile's activations in a per-block
scratch and runs K1, K2 and K3 on the tensor cores on ``pack_wide``'s tiles
(``csrc/wide_tc.cuh``; its layout and arithmetic are checked in
``tests/test_torch_wide_tc.py``). These tests check, without a GPU:

- the route: ``takes_chain`` is true exactly where the chain fits (width and
  depth; K1's obs carry beside the weight ring always fits), and every chain of
  positive widths is supported (264, 300, 512, 1024 wide, 12 products, where
  the wrappers raised before);
- the wrappers' CUDA branch against a stand-in library: each call reaches the
  entry of its route with arguments that fit the entry's ctypes signature and
  a scratch sized for its grid, and counts one launch.
"""
import numpy as np
import pytest
import torch

from mbrl_tpu_torch.ops import build
from mbrl_tpu_torch.ops import kernels as tk

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
    # K3 at 100 rows a member: one tile a block on the chain; on the wide
    # route the resident activations up to 512 columns, else the scratch
    k3_route = "tile" if not wide else "scratch" if name == "w1024" else "smem"
    assert tk.launch_counts() == {"fused_rollout_returns": 1, "fused_ensemble_mlp_gaussian": 1,
                                  "fused_ensemble_mlp": 1, **{
                                      f"fused_ensemble_mlp.{r}": int(r == k3_route)
                                      for r in tk.K3_ROUTES + tk.K3_WIDE_ROUTES},
                                  "fused_ensemble_mlp.fused_head": 0,
                                  "_forward_sharded.glue": 0,
                                  "fused_policy_mlp": 0, "fused_policy_mlp.repacks": 0,
                                  "fused_policy_mlp.linear": 0}
    if wide:  # each scratch holds its grid's blocks: K3 persistent, K2 (tiles, E), K1 tiles
        (_, k3), (_, k2), (_, k1) = fake_card.calls
        lay = tk.WideTileLayout(dims, False)
        # all three on the tensor cores: pack_wide's tiles, scratch in bytes of their layout
        assert k3[12] == k2[17] == lay.member_elems
        # K3 by shape: resident up to 512 columns (no scratch), else a scratch
        # of persistent blocks
        if lay.k3_resident:
            assert k3[-2] == tk.K3_WIDE_ROUTES.index("smem") and k3[-3] == 0
        else:
            assert k3[-2] == tk.K3_WIDE_ROUTES.index("scratch")
            assert k3[-3] == tk.persistent_blocks(100, 5, 132) * lay.block_bytes()
        assert k2[-2] == 2 * 5 * lay.block_bytes()
        assert k1[-2] == (batch // 64) * tk.WideTileLayout(stack1.dims, False).block_bytes(17)
        # the device dims hold the stack's dims
        assert tk._device_dims(dims, torch.device("cpu")).tolist() == list(dims)


def test_wide_wrappers_raise_only_for_what_no_route_takes(fake_card):
    x = torch.zeros((2, 8, 24))
    stack = _stack(WIDE_DIMS["w300"], torch.float32)
    with pytest.raises(TypeError):  # weights of another dtype
        tk.fused_ensemble_mlp(x, tk.MLPStack(stack.ws.double(), stack.bs, stack.dims, "silu"))
    with pytest.raises(ValueError):  # a stack that does not match its dims
        tk.fused_ensemble_mlp(x, tk.MLPStack(stack.ws[:, 1:].contiguous(), stack.bs, stack.dims, "silu"))
    with pytest.raises(ValueError):  # biases that do not match its dims
        tk.fused_ensemble_mlp(x, tk.MLPStack(stack.ws, stack.bs[:, 1:].contiguous(), stack.dims, "silu"))
    assert not fake_card.calls
    # any other chain of positive widths reaches the wide entry
    tk.fused_ensemble_mlp(x, stack)
    assert [c[0] for c in fake_card.calls] == ["mbrl_ensemble_mlp_wide"]
