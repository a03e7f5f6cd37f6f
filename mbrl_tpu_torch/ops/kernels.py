"""Ensemble-MLP rollout kernels (counterpart of ``mbrl_tpu/ops/pallas_kernels.py``).

Three kernels, hand-written in CUDA for Hopper, each beside a plain PyTorch
version of the same function with the same signature. All three run their
products on the tensor cores (``wgmma``) through one member-chain routine
(``csrc/tc_chain.cuh``): K1 and K2 in ``csrc/tc_chain.cu``, K3 in
``csrc/ensemble_mlp.cu``:

====  ==========================  ==========================================
K1    :func:`fused_rollout_returns`       whole H-step rollout, one launch
K2    :func:`fused_ensemble_mlp_gaussian` one step: chain + bounded Gaussian sample
K3    :func:`fused_ensemble_mlp`          equal-shard forward, raw head
====  ==========================  ==========================================

Dispatch depends only on where the tensors live: a CPU tensor goes through the
plain version; a CUDA tensor launches the kernel or raises (no fallback). Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

The weight stack is packed once per rollout (:func:`pack_mlp`): one (E, n_w)
tensor holding every product's (d_in, d_out) block row-major, in f32 or bf16,
and one (E, n_b) f32 tensor of biases. For a bf16 stack the operands of every
product are rounded to bf16 and accumulated in f32, as the TPU kernels do
(``pallas_kernels.py:186-195``, :352-353); the plain versions emulate that by
rounding to bf16 and multiplying in f32, which is exact for bf16 operands.

The kernels read their weights in another layout, packed once per rollout by
:func:`pack_chain` (:class:`ChainLayout`): chunks already in ``wgmma``'s
shared-memory layout, bf16, or for an f32 stack two tf32 copies (hi, lo) for
3xTF32 products that keep f32-grade results.

Each wrapper has two routes on the card, picked by :func:`takes_chain` from
the stack's :class:`ChainLayout`: the tensor-core chain for chains of at most
``MAX_PRODUCTS`` products with layers at most ``TC_MAX_WIDTH`` wide, and the
wide route (``csrc/wide_chain.cu``, :class:`WideLayout`) for any other width
and depth, with the same grid and one launch per call either way. The wide
route reads the stack's own weights, not the packed tiles.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mbrl_tpu_torch.device import seed_words

# compile-time activation codes of csrc/common.cuh
ACTIVATION_CODES: Dict[str, int] = {
    "relu": 0,
    "silu": 1,
    "swish": 1,
    "tanh": 2,
    "elu": 3,
    "gelu": 4,
    "leaky_relu": 5,
}

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "elu": F.elu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
}

# limits of the tensor-core chain (csrc/tc_chain.cuh): products of one chain,
# rows of one block's tile, widest layer (two warpgroups of at most 128
# accumulator columns), stages of the weight ring, and the shared memory a
# block can use; a stack past them takes the wide route (csrc/wide_chain.cu)
MAX_PRODUCTS = 9
MAX_TILE = 64
TC_MAX_WIDTH = 256
TC_MAX_STAGES = 4
TC_SMEM_BYTES = 232_448


@dataclasses.dataclass(frozen=True)
class MLPStack:
    """A packed ensemble weight stack: ``dims = (in, hid, ..., hid, head_out)``."""

    ws: torch.Tensor  # (E, n_w) float32 or bfloat16
    bs: torch.Tensor  # (E, n_b) float32
    dims: Tuple[int, ...]
    activation: str

    @property
    def num_members(self) -> int:
        return self.ws.shape[0]

    @property
    def num_products(self) -> int:
        return len(self.dims) - 1

    @property
    def low_precision(self) -> bool:
        return self.ws.dtype == torch.bfloat16

    def product(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Views of product ``i``'s weights (E, d_in, d_out) and bias (E, 1, d_out)."""
        w0 = sum(a * b for a, b in zip(self.dims[:i], self.dims[1 : i + 1]))
        b0 = sum(self.dims[1 : i + 1])
        din, dout = self.dims[i], self.dims[i + 1]
        e = self.num_members
        w = self.ws[:, w0 : w0 + din * dout].reshape(e, din, dout)
        b = self.bs[:, b0 : b0 + dout].reshape(e, 1, dout)
        return w, b


def pack_mlp(
    layer_ws: Sequence[torch.Tensor],
    layer_bs: Sequence[torch.Tensor],
    head_w: torch.Tensor,
    head_b: torch.Tensor,
    activation: str,
    dtype: torch.dtype = torch.float32,
) -> MLPStack:
    """Pack per-layer (E, d_in, d_out) weights and (E, 1, d_out) biases."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"Unknown activation {activation!r}")
    ws = list(layer_ws) + [head_w]
    bs = list(layer_bs) + [head_b]
    e = head_w.shape[0]
    dims = tuple([ws[0].shape[1]] + [w.shape[2] for w in ws])
    packed_w = torch.cat([w.reshape(e, -1).to(dtype) for w in ws], dim=1).contiguous()
    packed_b = torch.cat([b.reshape(e, -1).float() for b in bs], dim=1).contiguous()
    return MLPStack(packed_w, packed_b, dims, activation)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ChainLayout:
    """Where the kernels find a member's weights (mirrors ``make_chain_desc``
    in ``csrc/tc_chain.cuh``).

    Product i is a zero-padded (k_pad[i], n_pad[i]) matrix: K padded to the
    instruction depth (16 bf16, 8 tf32), N to the next layer's K, the head's N
    to a multiple of 8. It is cut into chunks of ``chunk`` K rows (the last
    may be shorter), each landed by one bulk copy. A chunk holds ``copies``
    blocks (bf16: the weights; f32: tf32 hi, then lo), each K-major in
    ``wgmma``'s unswizzled layout of 8-row x 16-byte core matrices: element
    (k, n) of a block sits at ``((k // t * n/8 + n // 8) * 8 + n % 8) * t + k % t``
    with t elements per 16 bytes, so K-adjacent core matrices are n/8 * 128
    bytes apart and N-adjacent ones 128.
    """

    dims: Tuple[int, ...]
    low_precision: bool

    @functools.cached_property
    def esize(self) -> int:
        return 2 if self.low_precision else 4

    @functools.cached_property
    def t(self) -> int:  # elements per 16 bytes
        return 16 // self.esize

    @functools.cached_property
    def copies(self) -> int:
        return 1 if self.low_precision else 2

    @functools.cached_property
    def chunk(self) -> int:
        return 64 if self.low_precision else 16

    @functools.cached_property
    def k_pad(self) -> Tuple[int, ...]:
        step = 16 if self.low_precision else 8
        return tuple(_round_up(d, step) for d in self.dims[:-1])

    @functools.cached_property
    def n_pad(self) -> Tuple[int, ...]:
        return self.k_pad[1:] + (_round_up(self.dims[-1], 8),)

    def product_offset(self, i: int) -> int:
        """Element offset of product i in a member's tiles."""
        return sum(k * n * self.copies for k, n in zip(self.k_pad[:i], self.n_pad[:i]))

    @functools.cached_property
    def member_elems(self) -> int:
        return self.product_offset(len(self.dims) - 1)

    @functools.lru_cache(maxsize=None)
    def stages(self, extra_bytes: int = 0) -> int:
        """Chunk buffers that fit in shared memory beside the activation tile
        (hi and lo copies, also holding the head output) and ``extra_bytes``."""
        rows = MAX_TILE
        a = max(self.copies * rows * max(self.k_pad) * self.esize, rows * self.n_pad[-1] * 4)
        stage = max(min(self.chunk, k) * n * self.esize * self.copies
                    for k, n in zip(self.k_pad, self.n_pad))
        # barriers (128 bytes) and the logvar bounds (1 KB) besides
        free = TC_SMEM_BYTES - 128 - 1024 - _round_up(a, 128) - extra_bytes
        return min(TC_MAX_STAGES, free // stage)


@dataclasses.dataclass(frozen=True)
class ChainTiles:
    """A weight stack packed for the kernels: ``w`` is (E, layout.member_elems),
    bf16, or f32 holding tf32 values."""

    w: torch.Tensor
    layout: ChainLayout


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10 mantissa bits), to nearest with ties away from
    zero as ``cvt.rna.tf32.f32`` does, on the bits; the 13 low bits come out 0."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _core_blocks(w: torch.Tensor, t: int) -> torch.Tensor:
    """(E, kc, n) → (E, kc * n) in the core-matrix order of :class:`ChainLayout`."""
    e, kc, n = w.shape
    return w.reshape(e, kc // t, t, n // 8, 8).permute(0, 1, 3, 4, 2).reshape(e, -1)


def pack_chain(stack: MLPStack) -> ChainTiles:
    """Pack ``stack`` into the kernels' layout (:class:`ChainLayout`); once per
    rollout, or once per model state (``GaussianMLP.packed``)."""
    lay = ChainLayout(stack.dims, stack.low_precision)
    parts = []
    for i in range(stack.num_products):
        w, _ = stack.product(i)
        kp, np_ = lay.k_pad[i], lay.n_pad[i]
        w = F.pad(w, (0, np_ - w.shape[2], 0, kp - w.shape[1]))
        if lay.low_precision:
            copies = [w]
        else:
            hi = rna_tf32(w)
            copies = [hi, rna_tf32(w - hi)]
        for k0 in range(0, kp, lay.chunk):
            parts += [_core_blocks(c[:, k0 : k0 + lay.chunk], lay.t) for c in copies]
    return ChainTiles(torch.cat(parts, dim=1).contiguous(), lay)


def unpack_chain(tiles: ChainTiles, i: int) -> Tuple[torch.Tensor, ...]:
    """Product i's padded (E, k_pad, n_pad) weights back out of the tiles: one
    tensor for bf16, (hi, lo) for f32."""
    lay = tiles.layout
    e = tiles.w.shape[0]
    kp, np_, t = lay.k_pad[i], lay.n_pad[i], lay.t
    off = lay.product_offset(i)
    blocks = [[] for _ in range(lay.copies)]
    for k0 in range(0, kp, lay.chunk):
        kc = min(lay.chunk, kp - k0)
        for c in range(lay.copies):
            n = kc * np_
            blk = tiles.w[:, off : off + n].reshape(e, kc // t, np_ // 8, 8, t)
            blocks[c].append(blk.permute(0, 1, 4, 2, 3).reshape(e, kc, np_))
            off += n
    return tuple(torch.cat(b, dim=1) for b in blocks)


@dataclasses.dataclass(frozen=True)
class WideLayout:
    """What the wide route reads (mirrors ``wide_sizes`` in
    ``csrc/wide_chain.cu``): the stack's own weights, product i's (d_in,
    d_out) block row-major at :meth:`w_offset` of a member's row of
    ``MLPStack.ws`` and its bias at :meth:`b_offset`; and the activation
    scratch of one block, two 64-row buffers at a row stride of the widest
    layer (``ld``), plus K1's obs carry and running return."""

    dims: Tuple[int, ...]

    @property
    def ld(self) -> int:
        return max(self.dims)

    def w_offset(self, i: int) -> int:
        return sum(a * b for a, b in zip(self.dims[:i], self.dims[1 : i + 1]))

    def b_offset(self, i: int) -> int:
        return sum(self.dims[1 : i + 1])

    @property
    def member_elems(self) -> int:
        return self.w_offset(len(self.dims) - 1)

    def block_floats(self, carry_dim: int = 0) -> int:
        """f32 scratch one block uses; ``carry_dim`` is K1's obs width (its
        carry and running return take ``MAX_TILE * (carry_dim + 1)`` more)."""
        carry = MAX_TILE * (carry_dim + 1) if carry_dim else 0
        return 2 * MAX_TILE * self.ld + carry


def supports_fused_mlp(dims: Sequence[int]) -> bool:
    """Whether K1, K2 and K3 take this chain on the card: any chain of at
    least one product of positive widths, by the tensor-core chain or the
    wide route (:func:`takes_chain`). Any row count is fine (the kernels mask
    the ragged last tile)."""
    return len(dims) >= 2 and all(d >= 1 for d in dims)


def takes_chain(dims: Sequence[int], low_precision: bool, extra_bytes: int = 0) -> bool:
    """Whether the tensor-core chain takes this stack (else the wide route
    does): at most ``MAX_PRODUCTS`` products of widths up to ``TC_MAX_WIDTH``,
    and room for two weight chunks beside the activation tile and
    ``extra_bytes`` (K1's obs carry). Mirrors ``make_chain_desc``'s refusal."""
    dims = tuple(dims)
    return (1 <= len(dims) - 1 <= MAX_PRODUCTS and all(1 <= d <= TC_MAX_WIDTH for d in dims)
            and ChainLayout(dims, low_precision).stages(extra_bytes) >= 2)


def persistent_blocks(rows_per_member: int, num_members: int, num_sms: int) -> int:
    """K3's grid: one block per (member, 64-row tile) until they outgrow the
    card's SMs (a block fills an SM's shared memory, so more would only
    queue), then one persistent block per SM that walks the tiles
    (:func:`block_tiles`)."""
    num_tiles = -(-rows_per_member // MAX_TILE)
    return min(num_members * num_tiles, num_sms)


def block_tiles(
    block: int, rows_per_member: int, num_members: int, blocks: int
) -> List[Tuple[int, int]]:
    """The (member, row tile) pairs that K3's block ``block`` of ``blocks``
    runs, in order (the kernel's tile loop): every ``blocks``-th of the
    member-major list, so the blocks' shares differ by at most one tile."""
    num_tiles = -(-rows_per_member // MAX_TILE)
    return [divmod(w, num_tiles) for w in range(block, num_members * num_tiles, blocks)]


def pick_tile(rows_per_member: int, max_tile: int = MAX_TILE, min_tile: int = 8) -> Optional[int]:
    """K1's row tile: the largest divisor of the member shard in
    ``[min_tile, max_tile]``, so that ``batch % tile == 0`` and
    ``num_tiles % E == 0``; None if there is none. (The TPU's rule,
    ``pallas_kernels.pick_tile``, wanted multiples of 8 up to 1024; a GPU block
    wants at most 64 rows so that B=8000 gives ~one wave of 125 blocks.)"""
    for t in range(min(rows_per_member, max_tile), min_tile - 1, -1):
        if rows_per_member % t == 0:
            return t
    return None


# --------------------------------------------------------------------------- #
# Plain PyTorch versions
# --------------------------------------------------------------------------- #
def _round_operand(h: torch.Tensor, low_precision: bool) -> torch.Tensor:
    return h.to(torch.bfloat16).float() if low_precision else h


def _plain_chain(x: torch.Tensor, stack: MLPStack) -> torch.Tensor:
    """(E, S, in) f32 → (E, S, head_out) f32 through the member chain."""
    act = ACTIVATIONS[stack.activation]
    h = x.float()
    last = stack.num_products - 1
    # plain reference path: full-f32 products, never TF32 (which keeps ~3
    # digits); the caller's setting comes back after the products
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(stack.num_products):
            w, b = stack.product(i)
            h = torch.bmm(_round_operand(h, stack.low_precision), w.float()) + b
            if i < last:
                h = act(h)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return h


def bound_logvar(
    logvar: torch.Tensor, max_logvar: torch.Tensor, min_logvar: torch.Tensor
) -> torch.Tensor:
    """Soft double-bounding of the raw logvar (reference gaussian_mlp.py:150-154),
    with JAX's softplus(x) = logaddexp(x, 0)."""
    zero = torch.zeros((), dtype=logvar.dtype, device=logvar.device)
    logvar = max_logvar - torch.logaddexp(max_logvar - logvar, zero)
    return min_logvar + torch.logaddexp(logvar - min_logvar, zero)


def _noise_generator(
    generator: torch.Generator, device: torch.device, sample: bool
) -> Optional[torch.Generator]:
    """The plain versions draw their noise from a generator on the tensors'
    device, seeded with two words drawn from ``generator`` (the two words the
    kernel's Philox is keyed on; drawn even when not sampling, as the kernel
    wrappers do, so both consume ``generator`` alike). None when not sampling."""
    s0, s1 = seed_words(generator, 2)
    if not sample:
        return None
    g = torch.Generator(device=device)
    g.manual_seed((s0 << 32) | s1)
    return g


def _bounded_gaussian(
    out: torch.Tensor,
    max_logvar: torch.Tensor,
    min_logvar: torch.Tensor,
    out_size: int,
    noise: Optional[torch.Generator],
) -> torch.Tensor:
    mean = out[..., :out_size]
    if noise is None:
        return mean
    logvar = bound_logvar(out[..., out_size:], max_logvar.reshape(-1), min_logvar.reshape(-1))
    z = torch.randn(mean.shape, generator=noise, device=mean.device)
    return mean + torch.exp(0.5 * logvar) * z


def fused_ensemble_mlp_plain(x: torch.Tensor, stack: MLPStack) -> torch.Tensor:
    return _plain_chain(x, stack)


def fused_ensemble_mlp_gaussian_plain(
    generator: torch.Generator,
    x: torch.Tensor,
    stack: MLPStack,
    max_logvar: torch.Tensor,
    min_logvar: torch.Tensor,
    out_size: int,
    sample: bool = True,
) -> torch.Tensor:
    noise = _noise_generator(generator, x.device, sample)
    return _bounded_gaussian(_plain_chain(x, stack), max_logvar, min_logvar, out_size, noise)


def fused_rollout_returns_plain(
    generator: torch.Generator,
    rot_tiles: torch.Tensor,
    obs0_rows: torch.Tensor,
    acts_rows: torch.Tensor,
    delta_mask: torch.Tensor,
    stack: MLPStack,
    max_logvar: torch.Tensor,
    min_logvar: torch.Tensor,
    out_size: int,
    tile: int,
    sample: bool = True,
) -> torch.Tensor:
    """Same member schedule as the kernel: row tile i uses member
    ``((i + rot[t]) % num_tiles) // tiles_per_member``. Rolling the batch by
    ``rot[t] * tile`` rows puts every member's tiles in one contiguous shard,
    so each step is one equal-shard chain."""
    batch, obs_dim = obs0_rows.shape
    horizon = acts_rows.shape[1]
    e = stack.num_members
    _check_rollout_shapes(batch, obs_dim, out_size, tile, e)
    noise = _noise_generator(generator, obs0_rows.device, sample)
    dmask = delta_mask.reshape(1, obs_dim)
    obs = obs0_rows.float()
    total = torch.zeros((batch, 1), dtype=torch.float32, device=obs.device)
    for t, r in enumerate(rot_tiles.tolist()):
        x = torch.cat([obs, acts_rows[:, t]], dim=-1)
        shift = int(r) * tile
        xs = torch.roll(x, shift, dims=0).reshape(e, batch // e, -1)
        out = torch.roll(_plain_chain(xs, stack).reshape(batch, -1), -shift, dims=0)
        pred = _bounded_gaussian(out, max_logvar, min_logvar, out_size, noise)
        raw_next = pred[:, : out_size - 1]
        obs = dmask * (obs + raw_next) + (1.0 - dmask) * raw_next
        total = total + pred[:, out_size - 1 :]
    return total


def _check_rollout_shapes(batch: int, obs_dim: int, out_size: int, tile: int, e: int) -> None:
    if obs_dim != out_size - 1:
        raise ValueError(f"obs dim {obs_dim} must be out_size - 1 = {out_size - 1}")
    if tile < 1 or batch % tile != 0 or (batch // tile) % e != 0:
        raise ValueError(f"tile {tile} must divide batch {batch} into a multiple of {e} tiles")


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check_cuda(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_stack(stack: MLPStack, device: torch.device) -> None:
    """What both routes need of the stack: types, device, and weights and
    biases as many as its dims say."""
    if not supports_fused_mlp(stack.dims):
        raise ValueError(f"chain dims {stack.dims} are not a chain of positive widths")
    if stack.ws.dtype not in (torch.float32, torch.bfloat16) or stack.bs.dtype != torch.float32:
        raise TypeError(f"weights must be f32/bf16 and biases f32, got {stack.ws.dtype}/{stack.bs.dtype}")
    _check_cuda(device, ws=stack.ws, bs=stack.bs)
    lay = WideLayout(stack.dims)
    if (stack.ws.dim() != 2 or stack.ws.shape[1] != lay.member_elems
            or tuple(stack.bs.shape) != (stack.num_members, lay.b_offset(stack.num_products))):
        raise ValueError(f"stack {tuple(stack.ws.shape)} / {tuple(stack.bs.shape)} does not "
                         f"match its dims {stack.dims}")


def _check_tiles(
    stack: MLPStack, tiles: Optional[ChainTiles], device: torch.device, extra_bytes: int = 0
) -> ChainTiles:
    """The chain route's checks of the packed tiles of a checked stack
    (packed here if None)."""
    if tiles is None:
        tiles = pack_chain(stack)
    lay = tiles.layout
    if (lay.dims != stack.dims or lay.low_precision != stack.low_precision
            or tiles.w.shape != (stack.num_members, lay.member_elems)):
        raise ValueError(f"tiles {lay} {tuple(tiles.w.shape)} do not match the stack {stack.dims}")
    if tiles.w.dtype != stack.ws.dtype:
        raise TypeError(f"tiles are {tiles.w.dtype}, the stack {stack.ws.dtype}")
    if lay.stages(extra_bytes) < 2:
        raise ValueError(f"chain dims {stack.dims} leave no room for two weight chunks in shared memory")
    _check_cuda(device, tiles=tiles.w)
    return tiles


def _check_f32(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _dims_arg(stack: MLPStack):
    return (ctypes.c_int * len(stack.dims))(*stack.dims)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on_error(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def _dispatch(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (132 on an H100)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _device_dims(dims: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The wide route's descriptor in device memory: the chain's dims, made
    once per (dims, device), so that a launch copies nothing from the host
    (and can be captured in a CUDA graph)."""
    return torch.tensor(dims, dtype=torch.int32, device=device)


def _wide_args(stack: MLPStack, device: torch.device, blocks: int, carry_dim: int = 0):
    """The wide entries' host dims and device dims, and a fresh scratch for
    ``blocks`` blocks (the caller keeps it alive until the launch is
    enqueued)."""
    scratch = torch.empty(blocks * WideLayout(stack.dims).block_floats(carry_dim),
                          dtype=torch.float32, device=device)
    return _dims_arg(stack), _device_dims(stack.dims, device).data_ptr(), scratch


def fused_ensemble_mlp(
    x: torch.Tensor, stack: MLPStack, tiles: Optional[ChainTiles] = None
) -> torch.Tensor:
    """K3: per-member-sharded ensemble forward, raw head. x (E, S, in) →
    (E, S, head_out), any head width (``2 * out`` of a Gaussian model, ``out``
    of a deterministic one). ``tiles`` is ``pack_chain(stack)``, packed here
    when not given (pack once per rollout or model state); the wide route
    reads the stack itself and ignores it."""
    if not _dispatch(x):
        return fused_ensemble_mlp_plain(x, stack)
    from mbrl_tpu_torch.ops.build import load_library

    e, rows, din = x.shape
    _check_f32(x=x)
    _check_cuda(x.device, x=x)
    _check_stack(stack, x.device)
    if e != stack.num_members or din != stack.dims[0] or rows < 1:
        raise ValueError(f"x {tuple(x.shape)} does not match stack dims {stack.dims} (E={stack.num_members})")
    out = torch.empty((e, rows, stack.dims[-1]), dtype=torch.float32, device=x.device)
    lib = load_library()
    blocks = persistent_blocks(rows, e, sm_count(x.device))
    act, low = ACTIVATION_CODES[stack.activation], int(stack.low_precision)
    if takes_chain(stack.dims, stack.low_precision):
        tiles = _check_tiles(stack, tiles, x.device)
        code = lib.mbrl_ensemble_mlp(
            x.data_ptr(), tiles.w.data_ptr(), stack.bs.data_ptr(), out.data_ptr(),
            _dims_arg(stack), stack.num_products, e, rows, blocks, act, low,
            tiles.layout.member_elems, _stream(x.device),
        )
    else:
        dims, dims_dev, scratch = _wide_args(stack, x.device, blocks)
        code = lib.mbrl_ensemble_mlp_wide(
            x.data_ptr(), stack.ws.data_ptr(), stack.bs.data_ptr(), out.data_ptr(), dims,
            dims_dev, stack.num_products, e, rows, blocks, act, low, stack.ws.shape[1],
            scratch.data_ptr(), scratch.numel(), _stream(x.device),
        )
    _raise_on_error(code, "fused_ensemble_mlp")
    fused_ensemble_mlp.launches += 1
    return out


def fused_ensemble_mlp_gaussian(
    generator: torch.Generator,
    x: torch.Tensor,
    stack: MLPStack,
    max_logvar: torch.Tensor,
    min_logvar: torch.Tensor,
    out_size: int,
    sample: bool = True,
    tiles: Optional[ChainTiles] = None,
) -> torch.Tensor:
    """K2: one rollout step, (E, S, in) → (E, S, out_size): a draw from the
    bounded Gaussian head (two seed words from ``generator`` key the kernel's
    Philox), or the head's mean when ``sample=False``. ``tiles`` is
    ``pack_chain(stack)``, packed here when not given (pack once per rollout);
    the wide route ignores it."""
    if not _dispatch(x):
        return fused_ensemble_mlp_gaussian_plain(
            generator, x, stack, max_logvar, min_logvar, out_size, sample
        )
    from mbrl_tpu_torch.ops.build import load_library

    e, rows, din = x.shape
    _check_f32(x=x, max_logvar=max_logvar, min_logvar=min_logvar)
    _check_cuda(x.device, x=x, max_logvar=max_logvar, min_logvar=min_logvar)
    _check_stack(stack, x.device)
    if e != stack.num_members or din != stack.dims[0] or stack.dims[-1] != 2 * out_size:
        raise ValueError(f"x {tuple(x.shape)} / out_size {out_size} do not match stack dims {stack.dims}")
    if max_logvar.numel() != out_size or min_logvar.numel() != out_size:
        raise ValueError("logvar bounds must have out_size entries")
    chain = takes_chain(stack.dims, stack.low_precision)
    if chain:
        tiles = _check_tiles(stack, tiles, x.device)
    s0, s1 = seed_words(generator, 2)
    out = torch.empty((e, rows, out_size), dtype=torch.float32, device=x.device)
    lib = load_library()
    act, low = ACTIVATION_CODES[stack.activation], int(stack.low_precision)
    if chain:
        code = lib.mbrl_ensemble_mlp_gaussian(
            s0, s1, x.data_ptr(), tiles.w.data_ptr(), stack.bs.data_ptr(),
            max_logvar.data_ptr(), min_logvar.data_ptr(), out.data_ptr(),
            _dims_arg(stack), stack.num_products, e, rows, out_size, int(sample), act, low,
            tiles.layout.member_elems, _stream(x.device),
        )
    else:
        dims, dims_dev, scratch = _wide_args(stack, x.device, -(-rows // MAX_TILE) * e)
        code = lib.mbrl_ensemble_mlp_gaussian_wide(
            s0, s1, x.data_ptr(), stack.ws.data_ptr(), stack.bs.data_ptr(),
            max_logvar.data_ptr(), min_logvar.data_ptr(), out.data_ptr(), dims, dims_dev,
            stack.num_products, e, rows, out_size, int(sample), act, low, stack.ws.shape[1],
            scratch.data_ptr(), scratch.numel(), _stream(x.device),
        )
    _raise_on_error(code, "fused_ensemble_mlp_gaussian")
    fused_ensemble_mlp_gaussian.launches += 1
    return out


def fused_rollout_returns(
    generator: torch.Generator,
    rot_tiles: torch.Tensor,
    obs0_rows: torch.Tensor,
    acts_rows: torch.Tensor,
    delta_mask: torch.Tensor,
    stack: MLPStack,
    max_logvar: torch.Tensor,
    min_logvar: torch.Tensor,
    out_size: int,
    tile: int,
    sample: bool = True,
    tiles: Optional[ChainTiles] = None,
) -> torch.Tensor:
    """K1: whole-horizon imagined rollout, per-row total learned reward (B, 1).

    rot_tiles (H,) int: cumulative tile-granular rotations; obs0_rows (B, D);
    acts_rows (B, H, A); delta_mask (1, D), 1 where the target is a delta.
    Requires D == out_size - 1, tile <= 64 dividing B into a multiple of E tiles.
    ``tiles`` is ``pack_chain(stack)``, packed here when not given; the wide
    route ignores it.
    """
    if not _dispatch(obs0_rows):
        return fused_rollout_returns_plain(
            generator, rot_tiles, obs0_rows, acts_rows, delta_mask, stack,
            max_logvar, min_logvar, out_size, tile, sample,
        )
    from mbrl_tpu_torch.ops.build import load_library

    batch, obs_dim = obs0_rows.shape
    if acts_rows.dim() != 3 or acts_rows.shape[0] != batch:
        raise ValueError(f"acts_rows must be (B, H, A), got {tuple(acts_rows.shape)}")
    horizon, act_dim = acts_rows.shape[1:]
    e = stack.num_members
    _check_rollout_shapes(batch, obs_dim, out_size, tile, e)
    if tile > MAX_TILE:
        raise ValueError(f"tile {tile} exceeds the kernel's {MAX_TILE} rows")
    if rot_tiles.dtype != torch.int32 or rot_tiles.shape != (horizon,):
        raise TypeError(f"rot_tiles must be int32 of shape ({horizon},)")
    if stack.dims[0] != obs_dim + act_dim or stack.dims[-1] != 2 * out_size:
        raise ValueError(f"stack dims {stack.dims} do not match obs {obs_dim} + act {act_dim} / out {out_size}")
    if delta_mask.numel() != obs_dim or max_logvar.numel() != out_size or min_logvar.numel() != out_size:
        raise ValueError("delta_mask / logvar bounds have the wrong size")
    _check_f32(obs0_rows=obs0_rows, acts_rows=acts_rows, delta_mask=delta_mask,
               max_logvar=max_logvar, min_logvar=min_logvar)
    _check_cuda(obs0_rows.device, rot_tiles=rot_tiles, obs0_rows=obs0_rows, acts_rows=acts_rows,
                delta_mask=delta_mask, max_logvar=max_logvar, min_logvar=min_logvar)
    dev = obs0_rows.device
    _check_stack(stack, dev)
    carry_bytes = 4 * MAX_TILE * (obs_dim + 1)
    chain = takes_chain(stack.dims, stack.low_precision, carry_bytes)
    if chain:
        tiles = _check_tiles(stack, tiles, dev, extra_bytes=carry_bytes)
    s0, s1 = seed_words(generator, 2)
    out = torch.empty((batch, 1), dtype=torch.float32, device=dev)
    lib = load_library()
    act, low = ACTIVATION_CODES[stack.activation], int(stack.low_precision)
    common = (rot_tiles.data_ptr(), obs0_rows.data_ptr(), acts_rows.data_ptr(),
              delta_mask.data_ptr())
    bounds = (max_logvar.data_ptr(), min_logvar.data_ptr(), out.data_ptr())
    if chain:
        code = lib.mbrl_rollout_returns(
            s0, s1, *common, tiles.w.data_ptr(), stack.bs.data_ptr(), *bounds,
            _dims_arg(stack), stack.num_products, e, batch, obs_dim, act_dim, horizon,
            out_size, tile, int(sample), act, low, tiles.layout.member_elems, _stream(dev),
        )
    else:
        dims, dims_dev, scratch = _wide_args(stack, dev, batch // tile, carry_dim=obs_dim)
        code = lib.mbrl_rollout_returns_wide(
            s0, s1, *common, stack.ws.data_ptr(), stack.bs.data_ptr(), *bounds, dims, dims_dev,
            stack.num_products, e, batch, obs_dim, act_dim, horizon, out_size, tile,
            int(sample), act, low, stack.ws.shape[1], scratch.data_ptr(), scratch.numel(),
            _stream(dev),
        )
    _raise_on_error(code, "fused_rollout_returns")
    fused_rollout_returns.launches += 1
    return out


KERNEL_WRAPPERS = (fused_rollout_returns, fused_ensemble_mlp_gaussian, fused_ensemble_mlp)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}
