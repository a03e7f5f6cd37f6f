"""Ensemble-MLP rollout kernels (counterpart of ``mbrl_tpu/ops/pallas_kernels.py``).

Three kernels, hand-written in CUDA for Hopper, each beside a plain PyTorch
version of the same function with the same signature. All three run their
products on the tensor cores (``wgmma``) through one member-chain routine
(``csrc/tc_chain.cuh``): K1 and K2 in ``csrc/tc_chain.cu``, K3 in
``csrc/ensemble_mlp.cu``:

====  ==========================  ==========================================
K1    :func:`fused_rollout_returns`       whole H-step rollout, one launch
K2    :func:`fused_ensemble_mlp_gaussian` one step: chain + bounded Gaussian sample
K3    :func:`fused_ensemble_mlp`          equal-shard forward, raw head (past one
                                          wave also: rows through the TS1
                                          permutation, the Gaussian head finished)
====  ==========================  ==========================================

Dispatch depends only on where the tensors live: a CPU tensor goes through the
plain version; a CUDA tensor launches the kernel or raises (no fallback). Each
wrapper counts its kernel launches in ``<wrapper>.launches``, K3 also by route
in ``fused_ensemble_mlp.route_launches`` (:func:`launch_counts`).

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
wide route for any other width and depth, with the same grid and one launch
per call either way. The wide route runs on the tensor cores too (K1 and K2
in ``csrc/wide_tc.cu``, K3 in ``csrc/ensemble_mlp_wide.cu``, all on
``csrc/wide_tc.cuh``), on weights packed by :func:`pack_wide`
(:class:`WideTileLayout`: the chain's layout in passes of ``WIDE_PASS``
columns) with the activations streamed from a per-block scratch. There K1
and K2 keep a bf16 stack's activations in shared memory where they fit
(``WideTileLayout.resident``), and on request run in clusters of blocks that
fetch each weight chunk once (:func:`wide_grid`, :func:`chunk_issuer`,
:func:`k1_shared`); K3 keeps any stack's up to 512 columns there, one pass a
product (``WideTileLayout.k3_resident``, :func:`k3_columns`,
:func:`k3_ring_copies`; ``csrc/ensemble_mlp_wide_smem.cu``). On the
chain K3 takes one of three routes by shape (:func:`k3_route`): one tile a
block in one wave, two tiles a block past it, a cluster of blocks a member
at a few rows a member.

Beside them, a kernel that replaces no Pallas kernel: the SAC policy's
forward (:func:`fused_policy_mlp`, ``csrc/policy_mlp.cu``), which the JAX
package leaves to XLA, for MBPO's imagined rollout, where the 1,024-wide
policy on 100,000 rows set the pace. ``GaussianPolicy.forward`` takes it for
large batches without grad (:data:`POLICY_KERNEL_ROWS`); its weights are
packed once per weight state (:func:`pack_policy`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mbrl_tpu_torch.device import seed_words
from mbrl_tpu_torch.util.profiling import annotate

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
# block can use; a stack past them takes the wide route (csrc/wide_tc.cuh)
MAX_PRODUCTS = 9
MAX_TILE = 64
TC_MAX_WIDTH = 256
TC_MAX_STAGES = 4
TC_SMEM_BYTES = 232_448
# the widest (padded) head the chain splits by K over its two warpgroups,
# which then leave two partial (MAX_TILE, n_pad) f32 tiles
TC_HEAD_SPLIT = 40
# output columns of one pass of the wide tensor-core route (csrc/wide_tc.cuh)
WIDE_PASS = 256
# K1's and K2's blocks on the wide route may go in clusters along x
# (csrc/wide_cluster.cu), whose blocks run row tiles of one member and fetch
# each weight chunk once for all of them: the sizes the entries take (4
# would need a second wave at config B's shape), and the cluster route's.
# The wrappers take one block a cluster unless asked: at config B's and A's
# shapes on an H100 80GB HBM3 (700 W) the 2-block clusters were slower than
# the plain ring in f32 and than the resident activations in bf16.
WIDE_CLUSTERS = (1, 2)
WIDE_CLUSTER = 2
# ring buffers that the wide route's resident-activation plans (K1's and K2's
# in bf16, csrc/wide_smem.cu; K3's, csrc/ensemble_mlp_wide_smem.cu) need
# beside their activation buffers
WIDE_SMEM_MIN_STAGES = 3
# K3's routes on the wide route (csrc/ensemble_mlp_wide.cu, in the entry's
# numbering): a tile's activations in a per-block scratch in device memory,
# or resident in shared memory where WideTileLayout.k3_resident holds
K3_WIDE_ROUTES = ("scratch", "smem")
# K3's routes on the chain (csrc/ensemble_mlp.cu, in the entry's numbering):
# one tile a block, two tiles a block, a cluster of blocks a member; the
# two-tile route's ring buffers at most and A bytes a k-step of a warpgroup;
# the blocks of a member's cluster at most
K3_ROUTES = ("tile", "pair", "cluster")
PAIR_MAX_STAGES = 8
PAIR_SLOT_BYTES = 2048
CLUSTER_MAX = 8
# rows a member up to which K3 takes the cluster route, f32 and bf16: on an
# H100 it beat one tile a block at 8 rows in f32 and lost at 8 in bf16
CLUSTER_ROWS = {False: 8, True: 2}


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

    def passes(self, i: int) -> Tuple[Tuple[int, int], ...]:
        """(first column, width) of each pass of product i's output columns:
        the chain takes them in one."""
        return ((0, self.n_pad[i]),)

    def product_offset(self, i: int) -> int:
        """Element offset of product i in a member's tiles."""
        return sum(k * n * self.copies for k, n in zip(self.k_pad[:i], self.n_pad[:i]))

    @functools.cached_property
    def member_elems(self) -> int:
        return self.product_offset(len(self.dims) - 1)

    @functools.cached_property
    def head_split(self) -> bool:
        """Whether the chain splits the head by K (two partial tiles)."""
        return self.n_pad[-1] <= TC_HEAD_SPLIT

    @functools.lru_cache(maxsize=None)
    def stages(self, extra_bytes: int = 0) -> int:
        """Chunk buffers that fit in shared memory beside the activation tile
        (hi and lo copies, also holding the head output) and ``extra_bytes``."""
        rows = MAX_TILE
        head = rows * self.n_pad[-1] * 4 * (2 if self.head_split else 1)
        a = max(self.copies * rows * max(self.k_pad) * self.esize, head)
        # barriers (128 bytes) and the logvar bounds (1 KB) besides
        free = TC_SMEM_BYTES - 128 - 1024 - _round_up(a, 128) - extra_bytes
        return min(TC_MAX_STAGES, free // self.stage_bytes)

    @functools.cached_property
    def stage_bytes(self) -> int:
        """One ring buffer: the largest chunk."""
        return max(min(self.chunk, k) * n * self.esize * self.copies
                   for k, n in zip(self.k_pad, self.n_pad))

    @functools.cached_property
    def pair_a_bytes(self) -> int:
        """K3's two-tile route: one warpgroup's A, a fragment-ordered copy of
        ``PAIR_SLOT_BYTES`` a k-step (one f32 or bf16 copy of 64 rows)."""
        return max(self.k_pad) // (16 if self.low_precision else 8) * PAIR_SLOT_BYTES

    @functools.cached_property
    def pair_bias_bytes(self) -> int:
        """K3's two-tile route: one warpgroup's copy of a member's biases."""
        return _round_up(4 * sum(self.dims[1:]), 16)

    @functools.cached_property
    def pair_stages(self) -> int:
        """Ring buffers of K3's two-tile route beside the barriers, two
        warpgroups' A and their biases (``make_pair_desc``); below 2 it
        does not fit."""
        free = TC_SMEM_BYTES - 128 - 2 * self.pair_a_bytes - 2 * self.pair_bias_bytes
        return min(PAIR_MAX_STAGES, free // self.stage_bytes)

    @functools.cached_property
    def pair_head_fits(self) -> bool:
        """Whether K3's two-tile route can finish a Gaussian head: its
        (64, padded head) f32 tile staged in one warpgroup's A region (mirrors
        ``launch_pair``'s check in ``csrc/ensemble_mlp.cu``)."""
        return MAX_TILE * 4 * self.n_pad[-1] <= self.pair_a_bytes

    @functools.cached_property
    def pair_smem_bytes(self) -> int:
        return (128 + 2 * self.pair_a_bytes + self.pair_stages * self.stage_bytes
                + 2 * self.pair_bias_bytes)


@dataclasses.dataclass(frozen=True)
class ChainTiles:
    """A weight stack packed for the kernels: ``w`` is (E, layout.member_elems),
    bf16, or f32 holding tf32 values."""

    w: torch.Tensor
    layout: ChainLayout


@dataclasses.dataclass(frozen=True)
class WideTileLayout(ChainLayout):
    """Where the wide tensor-core route (K1, K2) finds a member's weights and
    keeps a tile's activations (mirrors ``make_wide_desc`` in
    ``csrc/wide_tc.cuh``).

    Products are padded as in :class:`ChainLayout` and take as many elements,
    but each is cut first into passes of up to ``WIDE_PASS`` output columns
    (:meth:`passes`), then each pass into K chunks of ``chunk`` rows; a chunk
    holds its copies, each K-major in ``wgmma``'s layout at the pass's width
    (element (k, n) at ``((k // t * w/8 + n // 8) * 8 + n % 8) * t + k % t``
    for a pass w wide).

    A block's scratch (:meth:`block_bytes`) holds two activation buffers, the
    head's (64, ``n_pad[-1]``) f32 and, for K1, the obs carry and running
    return. An activation buffer holds a product's (64, k_pad) input in K
    chunks of ``chunk`` columns, each chunk its copies in the A layout of
    ``csrc/tc_chain.cuh:a_index``: what one bulk copy lands in a ring buffer.
    """

    def passes(self, i: int) -> Tuple[Tuple[int, int], ...]:
        """(first column, width) of each pass of product i."""
        n = self.n_pad[i]
        return tuple((p, min(WIDE_PASS, n - p)) for p in range(0, n, WIDE_PASS))

    @functools.cached_property
    def a_buf_bytes(self) -> int:
        return MAX_TILE * max(self.k_pad) * self.esize * self.copies

    def block_bytes(self, carry_dim: int = 0) -> int:
        """Scratch of one block; ``carry_dim`` is K1's obs width (its carry
        and running return take ``MAX_TILE * (carry_dim + 1)`` f32 more)."""
        carry = MAX_TILE * (carry_dim + 1) if carry_dim else 0
        return _round_up(2 * self.a_buf_bytes + 4 * MAX_TILE * self.n_pad[-1] + 4 * carry, 128)

    @functools.cached_property
    def stage_bytes(self) -> int:
        """One ring buffer: an A chunk slot (64 x chunk, every copy), then
        a weight chunk of the widest pass."""
        slot = MAX_TILE * self.chunk * self.esize * self.copies
        return slot + self.chunk * min(WIDE_PASS, max(self.n_pad)) * self.esize * self.copies

    @functools.lru_cache(maxsize=None)
    def stages(self, extra_bytes: int = 0) -> int:
        """Ring buffers that fit in shared memory beside the barriers (the
        obs carry lives in the scratch, so ``extra_bytes`` does not count)."""
        return min(TC_MAX_STAGES, (TC_SMEM_BYTES - 128) // self.stage_bytes)

    @functools.cached_property
    def smem_stages(self) -> int:
        """Ring buffers of the resident-activation plan (``make_smem_desc``):
        weight chunks only, beside the barriers and two resident activation
        buffers of ``a_buf_bytes``; 0 for an f32 stack (its hi/lo buffers do
        not fit)."""
        if not self.low_precision:
            return 0
        weights = self.stage_bytes - MAX_TILE * self.chunk * self.esize * self.copies
        return max(0, min(TC_MAX_STAGES, (TC_SMEM_BYTES - 128 - 2 * self.a_buf_bytes) // weights))

    @functools.cached_property
    def k3_slice(self) -> int:
        """K rows of one ring buffer of K3's resident route (every pass of a
        product): one k-step f32, two bf16."""
        return 32 if self.low_precision else 8

    @functools.cached_property
    def k3_head_split(self) -> bool:
        """Whether K3's resident route splits the head by K over its two
        warpgroups (f32, at most ``TC_HEAD_SPLIT`` padded columns, as the
        chain)."""
        return not self.low_precision and self.n_pad[-1] <= TC_HEAD_SPLIT

    @functools.cached_property
    def k3_a_bytes(self) -> int:
        """K3's resident activation buffer: 64 rows of the widest input, one
        f32 or bf16 copy laid out by A fragment (``PAIR_SLOT_BYTES`` a
        k-step); at least a head split by K's (64, n_pad) f32 partial sums."""
        part = 4 * MAX_TILE * self.n_pad[-1] if self.k3_head_split else 0
        return max(MAX_TILE * max(self.k_pad) * self.esize, part)

    @functools.cached_property
    def k3_stage_bytes(self) -> int:
        """One ring buffer of K3's resident route: ``k3_slice`` K rows of the
        widest product, every pass and copy, and in f32 at least one chunk of
        the widest one-pass product."""
        one_pass = [n for n in self.n_pad if n <= WIDE_PASS and not self.low_precision]
        rows = max(self.k3_slice * max(self.n_pad), self.chunk * max(one_pass, default=0))
        return rows * self.esize * self.copies

    def k3_rows(self, i: int) -> int:
        """K rows of one ring buffer of product i on K3's resident route:
        ``k3_slice`` of every pass, or in f32 as many whole chunks of a
        one-pass product as a buffer holds."""
        n = self.n_pad[i]
        if n > WIDE_PASS or self.low_precision:
            return self.k3_slice
        return self.k3_stage_bytes // (self.chunk * n * self.esize * self.copies) * self.chunk

    @functools.cached_property
    def k3_stages(self) -> int:
        """Ring buffers of K3's resident plan (``make_wide_smem_desc``) beside
        the barriers, the activation buffer and one product's biases; 0 where
        a product is wider than two passes (a warpgroup takes at most one)."""
        nmax = max(self.n_pad)
        if nmax > 2 * WIDE_PASS:
            return 0
        free = TC_SMEM_BYTES - 128 - self.k3_a_bytes - 4 * nmax
        return max(0, min(TC_MAX_STAGES, free // self.k3_stage_bytes))

    @functools.cached_property
    def k3_smem_bytes(self) -> int:
        return 128 + self.k3_a_bytes + self.k3_stages * self.k3_stage_bytes + 4 * max(self.n_pad)

    @property
    def k3_resident(self) -> bool:
        """Whether K3 keeps this stack's activations in shared memory
        (``csrc/ensemble_mlp_wide_smem.cu``; every padded layer at most 512
        columns), where the other wide stacks stream them from the scratch."""
        return self.k3_stages >= WIDE_SMEM_MIN_STAGES

    @property
    def resident(self) -> bool:
        """Whether K1 and K2 keep this stack's activations in shared memory
        (a bf16 stack whose two activation buffers leave room for
        ``WIDE_SMEM_MIN_STAGES`` weight chunks: at most 512 columns), where
        the other wide stacks stream them from the scratch."""
        return self.smem_stages >= WIDE_SMEM_MIN_STAGES


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10 mantissa bits), to nearest with ties away from
    zero as ``cvt.rna.tf32.f32`` does, on the bits; the 13 low bits come out 0."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _core_blocks(w: torch.Tensor, t: int) -> torch.Tensor:
    """(E, kc, n) → (E, kc * n) in the core-matrix order of :class:`ChainLayout`."""
    e, kc, n = w.shape
    return w.reshape(e, kc // t, t, n // 8, 8).permute(0, 1, 3, 4, 2).reshape(e, -1)


def _pack(stack: MLPStack, lay: ChainLayout) -> ChainTiles:
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
        for p0, width in lay.passes(i):
            for k0 in range(0, kp, lay.chunk):
                parts += [_core_blocks(c[:, k0 : k0 + lay.chunk, p0 : p0 + width], lay.t)
                          for c in copies]
    return ChainTiles(torch.cat(parts, dim=1).contiguous(), lay)


def pack_chain(stack: MLPStack) -> ChainTiles:
    """Pack ``stack`` into the kernels' layout (:class:`ChainLayout`); once per
    rollout, or once per model state (``GaussianMLP.packed``)."""
    return _pack(stack, ChainLayout(stack.dims, stack.low_precision))


def pack_wide(stack: MLPStack) -> ChainTiles:
    """Pack ``stack`` for the wide tensor-core route (:class:`WideTileLayout`);
    once per model state (``GaussianMLP.packed``), or per call when not given."""
    return _pack(stack, WideTileLayout(stack.dims, stack.low_precision))


def pack_tiles(stack: MLPStack, extra_bytes: int = 0) -> ChainTiles:
    """The packed tiles of the route :func:`takes_chain` picks for ``stack``."""
    if takes_chain(stack.dims, stack.low_precision, extra_bytes):
        return pack_chain(stack)
    return pack_wide(stack)


def unpack_chain(tiles: ChainTiles, i: int) -> Tuple[torch.Tensor, ...]:
    """Product i's padded (E, k_pad, n_pad) weights back out of the tiles (of
    either layout), walking passes and chunks in the kernels' order: one
    tensor for bf16, (hi, lo) for f32."""
    lay = tiles.layout
    e, t = tiles.w.shape[0], lay.t
    kp, np_ = lay.k_pad[i], lay.n_pad[i]
    out = [tiles.w.new_zeros((e, kp, np_)) for _ in range(lay.copies)]
    off = lay.product_offset(i)
    for p0, width in lay.passes(i):
        for k0 in range(0, kp, lay.chunk):
            kc = min(lay.chunk, kp - k0)
            for c in range(lay.copies):
                n = kc * width
                blk = tiles.w[:, off : off + n].reshape(e, kc // t, width // 8, 8, t)
                out[c][:, k0 : k0 + kc, p0 : p0 + width] = blk.permute(0, 1, 4, 2, 3).reshape(e, kc, width)
                off += n
    return tuple(out)


def supports_fused_mlp(dims: Sequence[int]) -> bool:
    """Whether K1, K2 and K3 take this chain on the card: any chain of at
    least one product of positive widths, by the tensor-core chain or the
    wide route (:func:`takes_chain`). Any row count is fine (the kernels mask
    the ragged last tile)."""
    return len(dims) >= 2 and all(d >= 1 for d in dims)


def k2_extra_bytes(out_size: int) -> int:
    """Shared memory K2 takes on the chain beside the stack's plan: a tile's
    (MAX_TILE, out_size) f32 normals."""
    return 4 * MAX_TILE * out_size


def k1_extra_bytes(obs_dim: int, out_size: int) -> int:
    """Shared memory K1 takes on the chain beside the stack's plan: the obs
    carry and running return, (MAX_TILE, obs_dim + 1) f32, and two buffers
    of a step's normals."""
    return 4 * MAX_TILE * (obs_dim + 1 + 2 * out_size)


def takes_chain(dims: Sequence[int], low_precision: bool, extra_bytes: int = 0) -> bool:
    """Whether the tensor-core chain takes this stack (else the wide route
    does): at most ``MAX_PRODUCTS`` products of widths up to ``TC_MAX_WIDTH``,
    and room for two weight chunks beside the activation tile and
    ``extra_bytes`` (:func:`k2_extra_bytes`, :func:`k1_extra_bytes`). Mirrors
    ``make_chain_desc``'s refusal."""
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


def cluster_size(num_members: int, num_sms: int) -> int:
    """Blocks of a member's cluster on K3's cluster route: as many as the
    card holds for every member at once, at most ``CLUSTER_MAX``."""
    return min(CLUSTER_MAX, num_sms // num_members)


def k3_route(rows_per_member: int, num_members: int, num_sms: int, low_precision: bool) -> str:
    """K3's route on the chain (mirrors ``mbrl_ensemble_mlp``): a cluster of
    blocks a member for at most ``CLUSTER_ROWS`` rows a member when the card
    holds clusters of two or more for every member; one tile a block while
    the (member, tile) pairs fit in one wave; two tiles a block past it."""
    num_tiles = -(-rows_per_member // MAX_TILE)
    if (rows_per_member <= CLUSTER_ROWS[low_precision]
            and cluster_size(num_members, num_sms) >= 2):
        return "cluster"
    return "pair" if num_members * num_tiles > num_sms else "tile"


def cluster_smem_bytes(dims: Sequence[int], rows_per_member: int) -> int:
    """Shared memory of a block on K3's cluster route (``make_plain_desc``):
    two (rows, widest input) f32 activation buffers and the 8 warps' partial
    sums of 8 rows x 32 columns."""
    return 4 * (2 * rows_per_member * max(dims[:-1]) + 8 * 8 * 32)


def pair_blocks(rows_per_member: int, num_members: int, num_sms: int) -> int:
    """K3's grid on the two-tile route: one block per (member, tile pair)
    until they outgrow the card's SMs, then one persistent block per SM
    that walks the pairs (:func:`block_pairs`)."""
    num_tiles = -(-rows_per_member // MAX_TILE)
    return min(num_members * -(-num_tiles // 2), num_sms)


def block_pairs(
    block: int, rows_per_member: int, num_members: int, blocks: int
) -> List[Tuple[int, Tuple[int, ...]]]:
    """The (member, (tile, tile)) pairs that block ``block`` of ``blocks``
    runs on K3's two-tile route, in order: every ``blocks``-th of the
    member-major list of pairs, so the blocks' shares differ by at most one
    pair; a member's odd last tile is a pair of one (the kernel's second
    warpgroup idles through it)."""
    num_tiles = -(-rows_per_member // MAX_TILE)
    per = -(-num_tiles // 2)
    out = []
    for p in range(block, num_members * per, blocks):
        e, k = divmod(p, per)
        out.append((e, tuple(t for t in (2 * k, 2 * k + 1) if t < num_tiles)))
    return out


def k3_blocks(route: str, rows_per_member: int, num_members: int, num_sms: int) -> int:
    """K3's grid on the chain for ``route`` (:func:`k3_route`)."""
    if route == "cluster":
        return num_members * cluster_size(num_members, num_sms)
    if route == "pair":
        return pair_blocks(rows_per_member, num_members, num_sms)
    return persistent_blocks(rows_per_member, num_members, num_sms)


def k3_fuses_head(layout: ChainLayout, rows_per_member: int, num_members: int,
                  num_sms: Optional[int], gaussian: bool) -> bool:
    """Whether K3 takes the rows of a TS1 step through its permutation and
    finishes the Gaussian head in its epilogue (:func:`fused_ensemble_mlp`'s
    ``perm``, ``logvar_bounds``, ``noise``): for a ``gaussian`` head, on the
    card (``num_sms``; None off it), for a stack the chain takes (``layout``,
    the packed tiles' layout) on its two-tile route (:func:`k3_route`: more
    (member, tile) pairs than one wave), with room to stage the head
    (``ChainLayout.pair_head_fits``). Any other call keeps the raw head and
    PyTorch's gather, bound, scatter and draw around it."""
    return (gaussian and num_sms is not None and not isinstance(layout, WideTileLayout)
            and k3_route(rows_per_member, num_members, num_sms, layout.low_precision) == "pair"
            and layout.pair_head_fits)


def wide_grid(num_tiles: int, cluster: int) -> int:
    """The wide route's blocks along x for ``num_tiles`` row tiles (K2's of a
    member, K1's of the batch): padded to a multiple of ``cluster``; a
    padded block runs a zero tile for its share of the weight stream and
    writes nothing."""
    if cluster not in WIDE_CLUSTERS:
        raise ValueError(f"cluster {cluster} is not one of {WIDE_CLUSTERS}")
    return -(-num_tiles // cluster) * cluster


def wide_ring(layout: "WideTileLayout") -> List[Tuple[int, int, int]]:
    """The ring buffers of one chain on the wide route, in the order the
    producer fills them (``produce_wide``): (product, first column of the
    pass, first K row of the chunk)."""
    return [(i, p0, k0) for i in range(len(layout.dims) - 1) for p0, _ in layout.passes(i)
            for k0 in range(0, layout.k_pad[i], layout.chunk)]


def k3_columns(n_pad: int, wg: int, unit: int, split: bool = False) -> Tuple[int, int, int, int]:
    """Where warpgroup ``wg``'s columns of a product ``n_pad`` wide lie on
    K3's resident route (``k3_cols``): (first column of its pass, the pass's
    width, its first column in the pass, its 8-column groups). Two passes:
    warpgroup ``wg`` takes pass ``wg``; one: warpgroup 0 the first half of the
    groups in units of ``unit`` (2 for a bf16 hidden layer), 1 the rest; a
    head split by K (``split``): both every column."""
    if n_pad > WIDE_PASS:
        w = n_pad - WIDE_PASS if wg else WIDE_PASS
        return wg * WIDE_PASS, w, 0, w // 8
    if split:
        return 0, n_pad, 0, n_pad // 8
    half = (n_pad // 8 // unit + 1) // 2 * unit
    return 0, n_pad, 8 * half if wg else 0, n_pad // 8 - half if wg else half


def k3_ring_copies(layout: "WideTileLayout") -> List[Tuple[int, int, List[Tuple[int, int, int]]]]:
    """The ring buffers of one chain on K3's resident route, in the order the
    producer fills them (``produce_k3_smem``): (product, first K row, [(source
    element offset in a member's tiles, destination element offset in the
    buffer, elements), ...]): one copy a pass and tf32 copy, or of an f32
    one-pass product one copy of whole chunks."""
    out = []
    prod = 0
    for i in range(len(layout.dims) - 1):
        kp, np_ = layout.k_pad[i], layout.n_pad[i]
        rows = layout.k3_rows(i)
        for k in range(0, kp, rows):
            sl = min(rows, kp - k)
            if np_ <= WIDE_PASS and not layout.low_precision:  # whole chunks: one run of the tiles
                out.append((i, k, [(prod + k * np_ * layout.copies, 0, sl * np_ * layout.copies)]))
                continue
            k0 = k // layout.chunk * layout.chunk
            kc = min(layout.chunk, kp - k0)
            copies, dst = [], 0
            for p0, w in layout.passes(i):
                src = prod + p0 * kp * layout.copies + k0 * w * layout.copies + (k - k0) * w
                for c in range(layout.copies):
                    copies.append((src + c * kc * w, dst, sl * w))
                    dst += sl * w
            out.append((i, k, copies))
        prod += kp * np_ * layout.copies
    return out


def chunk_issuer(it: int, share: int) -> int:
    """The rank of the block that fetches ring buffer ``it``'s weight chunk
    for the first ``share`` blocks of its cluster (multicast into each); with
    ``share`` 1 every block fetches its own."""
    return it % share


def k1_member(tile: int, rot: int, num_tiles: int, tiles_per_member: int, cluster: int) -> int:
    """K1's member for row tile ``tile`` at a step of rotation ``rot``; a
    padded tile (``tile >= num_tiles``) takes its cluster's first tile's
    (``k1_member`` in ``csrc/wide_tc.cu``)."""
    if tile >= num_tiles:
        tile -= tile % cluster
    return ((tile + rot) % num_tiles) // tiles_per_member


def k1_shared(first: int, cluster: int, rot: int, num_tiles: int, tiles_per_member: int) -> bool:
    """Whether the tiles of K1's cluster from ``first`` use one member at a
    step of rotation ``rot`` and so share its weight stream (else each block
    copies its own)."""
    members = {k1_member(first + q, rot, num_tiles, tiles_per_member, cluster)
               for q in range(cluster)}
    return len(members) == 1


def k1_straddles(rot: Sequence[int], num_tiles: int, tiles_per_member: int,
                 cluster: int) -> List[List[int]]:
    """For each of K1's clusters, the steps at which its tiles straddle two
    members under the rotations ``rot`` (one a step)."""
    return [[t for t, r in enumerate(rot)
             if not k1_shared(first, cluster, int(r), num_tiles, tiles_per_member)]
            for first in range(0, wide_grid(num_tiles, cluster), cluster)]


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


def fused_ensemble_mlp_head_plain(
    x: torch.Tensor,
    stack: MLPStack,
    perm: torch.Tensor,
    max_logvar: torch.Tensor,
    min_logvar: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`fused_ensemble_mlp` with the Gaussian head, plain: the batch
    ``x`` (E, S, in) gathered by ``perm`` into each member's shard, the
    chain, the bounded log-variance, both put back in the batch's order, then
    the draw ``mean + exp(logvar / 2) * noise`` when ``noise`` (B, out) is
    given. The same operations on the same layouts as ``GaussianMLP``'s
    ``_permute_rows``, ``_bound``, ``_unpermute_rows`` and ``sample_1d``, so
    bit-equal to them; the kernel draws before it writes, which is the same
    arithmetic row by row."""
    e, rows, din = x.shape
    batch = e * rows
    raw = _plain_chain(x.reshape(batch, din)[perm].reshape(e, rows, din), stack)
    out_size = raw.shape[-1] // 2
    mean = raw[..., :out_size].reshape(batch, -1)
    logvar = bound_logvar(raw[..., out_size:], max_logvar, min_logvar).reshape(batch, -1)
    mean_b, logvar_b = torch.empty_like(mean), torch.empty_like(logvar)
    mean_b[perm], logvar_b[perm] = mean, logvar
    if noise is None:
        return mean_b, logvar_b
    return mean_b + torch.exp(0.5 * logvar_b) * noise, None


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
    n_w = sum(a * b for a, b in zip(stack.dims[:-1], stack.dims[1:]))
    if (stack.ws.dim() != 2 or stack.ws.shape[1] != n_w
            or tuple(stack.bs.shape) != (stack.num_members, sum(stack.dims[1:]))):
        raise ValueError(f"stack {tuple(stack.ws.shape)} / {tuple(stack.bs.shape)} does not "
                         f"match its dims {stack.dims}")


def _check_tiles(
    stack: MLPStack, tiles: Optional[ChainTiles], device: torch.device, extra_bytes: int = 0
) -> ChainTiles:
    """The checks of the packed tiles of a checked stack, for the route
    :func:`takes_chain` picks (packed here if None)."""
    if tiles is None:
        tiles = pack_tiles(stack, extra_bytes)
    lay = tiles.layout
    if isinstance(lay, WideTileLayout) == takes_chain(stack.dims, stack.low_precision, extra_bytes):
        raise ValueError(f"tiles {type(lay).__name__} were packed for the other route of {stack.dims}")
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


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card, where a caller that picks its route by
    shape may take a kernel."""
    return t.device.type == "cuda"


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


def _wide_scratch(layout: WideTileLayout, device: torch.device, blocks: int,
                  carry_dim: int = 0) -> torch.Tensor:
    """A fresh scratch of ``blocks`` blocks for the wide tensor-core route, in
    bytes (the caller keeps it alive until the launch is enqueued)."""
    return torch.empty(blocks * layout.block_bytes(carry_dim), dtype=torch.uint8, device=device)


def wide_max_active_clusters(stack: MLPStack, k1: bool, cluster: int, device: torch.device,
                             obs_dim: int = 0) -> int:
    """The clusters of ``cluster`` blocks of K1's (``k1``) or K2's wide kernel
    for ``stack`` that the card holds at once (``cudaOccupancyMaxActiveClusters``):
    a grid of more blocks than ``cluster`` times this runs in a second wave."""
    from mbrl_tpu_torch.ops.build import load_library

    count = ctypes.c_int(0)
    code = load_library().mbrl_wide_max_active_clusters(
        int(k1), _dims_arg(stack), stack.num_products, obs_dim + 1 if k1 else 0,
        ACTIVATION_CODES[stack.activation], int(stack.low_precision), cluster,
        ctypes.byref(count))
    _raise_on_error(code, "wide_max_active_clusters")
    return count.value


def fused_ensemble_mlp(
    x: torch.Tensor,
    stack: MLPStack,
    tiles: Optional[ChainTiles] = None,
    *,
    perm: Optional[torch.Tensor] = None,
    logvar_bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    noise: Optional[torch.Tensor] = None,
):
    """K3: per-member-sharded ensemble forward, raw head. x (E, S, in) →
    (E, S, head_out), any head width (``2 * out`` of a Gaussian model, ``out``
    of a deterministic one). ``tiles`` is ``pack_tiles(stack)`` (the chain's
    or the wide route's), packed here when not given (pack once per rollout
    or model state). On the wide route K3 keeps a tile's activations in
    shared memory where ``WideTileLayout.k3_resident`` holds, else in a
    scratch in device memory.

    With ``perm`` (B = E * S, int64, a permutation) and ``logvar_bounds``
    ``(max_logvar, min_logvar)`` (out each), K3 works in the batch's order
    and finishes the Gaussian head: ``x`` is the batch (B, in) viewed as
    (E, S, in), slot p of member e takes batch row ``perm[e * S + p]``, and
    the results come back by batch row, ``(mean, logvar)`` each (B, out), or
    with ``noise`` (B, out) the draw ``(mean + exp(logvar / 2) * noise, None)``.
    On the card only the two-tile route does that (:func:`k3_fuses_head`
    says when); other shapes raise."""
    with annotate("fused_ensemble_mlp"):
        if (perm is None) != (logvar_bounds is None) or (noise is not None and perm is None):
            raise ValueError("perm and logvar_bounds come together, and noise only with them")
        if not _dispatch(x):
            if perm is None:
                return fused_ensemble_mlp_plain(x, stack)
            return fused_ensemble_mlp_head_plain(x, stack, perm, *logvar_bounds, noise)
        from mbrl_tpu_torch.ops.build import load_library

        e, rows, din = x.shape
        _check_f32(x=x)
        _check_cuda(x.device, x=x)
        _check_stack(stack, x.device)
        if e != stack.num_members or din != stack.dims[0] or rows < 1:
            raise ValueError(f"x {tuple(x.shape)} does not match stack dims {stack.dims} (E={stack.num_members})")
        tiles = _check_tiles(stack, tiles, x.device)
        lib = load_library()
        if perm is not None:
            return _fused_head(lib, x, stack, tiles, perm, logvar_bounds, noise)
        act, low = ACTIVATION_CODES[stack.activation], int(stack.low_precision)
        out = torch.empty((e, rows, stack.dims[-1]), dtype=torch.float32, device=x.device)
        head = (x.data_ptr(), tiles.w.data_ptr(), stack.bs.data_ptr(), out.data_ptr(), _dims_arg(stack))
        if not isinstance(tiles.layout, WideTileLayout):
            route = k3_route(rows, e, sm_count(x.device), stack.low_precision)
            blocks = k3_blocks(route, rows, e, sm_count(x.device))
            tail = (stack.num_products, e, rows, blocks, act, low, tiles.layout.member_elems)
            code = lib.mbrl_ensemble_mlp(*head, *tail, stack.ws.data_ptr(), K3_ROUTES.index(route),
                                         _stream(x.device))
        else:
            blocks = persistent_blocks(rows, e, sm_count(x.device))
            tail = (stack.num_products, e, rows, blocks, act, low, tiles.layout.member_elems)
            dims = _device_dims(stack.dims, x.device).data_ptr()
            if tiles.layout.k3_resident:  # no scratch: the activations stay in shared memory
                route = "smem"
                code = lib.mbrl_ensemble_mlp_wide(*head, dims, *tail, None, 0,
                                                  K3_WIDE_ROUTES.index(route), _stream(x.device))
            else:
                route = "scratch"
                scratch = _wide_scratch(tiles.layout, x.device, blocks)
                code = lib.mbrl_ensemble_mlp_wide(*head, dims, *tail, scratch.data_ptr(),
                                                  scratch.numel(), K3_WIDE_ROUTES.index(route),
                                                  _stream(x.device))
        _raise_on_error(code, "fused_ensemble_mlp")
        fused_ensemble_mlp.launches += 1
        fused_ensemble_mlp.route_launches[route] += 1
        return out


def _fused_head(lib, x, stack, tiles, perm, logvar_bounds, noise):
    """:func:`fused_ensemble_mlp`'s launch with the Gaussian head
    (``mbrl_ensemble_mlp_head``), its arguments checked."""
    e, rows, _ = x.shape
    batch, out_size, dev = e * rows, stack.dims[-1] // 2, x.device
    max_lv, min_lv = (b.reshape(-1) for b in logvar_bounds)
    if not k3_fuses_head(tiles.layout, rows, e, sm_count(dev), True):
        raise ValueError(f"K3 finishes the Gaussian head on its two-tile route only: dims "
                         f"{stack.dims} at {rows} rows a member of {e}")
    if perm.dtype != torch.int64 or tuple(perm.shape) != (batch,):
        raise ValueError(f"perm must be int64 of shape ({batch},), got {perm.dtype} {tuple(perm.shape)}")
    if max_lv.numel() != out_size or min_lv.numel() != out_size:
        raise ValueError(f"logvar bounds must hold {out_size} values each, for head {stack.dims[-1]}")
    if noise is not None and tuple(noise.shape) != (batch, out_size):
        raise ValueError(f"noise must be ({batch}, {out_size}), got {tuple(noise.shape)}")
    floats = {"max_logvar": max_lv, "min_logvar": min_lv}
    if noise is not None:
        floats["noise"] = noise
    _check_f32(**floats)
    _check_cuda(dev, perm=perm, **floats)
    out = torch.empty((batch, out_size), dtype=torch.float32, device=dev)
    lv = None if noise is not None else torch.empty_like(out)
    code = lib.mbrl_ensemble_mlp_head(
        x.data_ptr(), tiles.w.data_ptr(), stack.bs.data_ptr(), perm.data_ptr(), max_lv.data_ptr(),
        min_lv.data_ptr(), None if noise is None else noise.data_ptr(), out.data_ptr(),
        None if lv is None else lv.data_ptr(), _dims_arg(stack), stack.num_products, e, rows,
        k3_blocks("pair", rows, e, sm_count(dev)), ACTIVATION_CODES[stack.activation],
        int(stack.low_precision), tiles.layout.member_elems, out_size, _stream(dev))
    _raise_on_error(code, "fused_ensemble_mlp")
    fused_ensemble_mlp.launches += 1
    fused_ensemble_mlp.route_launches["pair"] += 1
    HEAD_COUNTS["fused_ensemble_mlp.fused_head"] += 1
    return out, lv


def fused_ensemble_mlp_gaussian(
    generator: torch.Generator,
    x: torch.Tensor,
    stack: MLPStack,
    max_logvar: torch.Tensor,
    min_logvar: torch.Tensor,
    out_size: int,
    sample: bool = True,
    tiles: Optional[ChainTiles] = None,
    cluster: int = 1,
) -> torch.Tensor:
    """K2: one rollout step, (E, S, in) → (E, S, out_size): a draw from the
    bounded Gaussian head (two seed words from ``generator`` key the kernel's
    Philox), or the head's mean when ``sample=False``. ``tiles`` is
    ``pack_tiles(stack, k2_extra_bytes(out_size))`` (the chain's or the wide
    route's), packed here when not given (pack once per rollout or model
    state). ``cluster``: the blocks of a cluster on the wide route, one of
    ``WIDE_CLUSTERS``."""
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
    tiles = _check_tiles(stack, tiles, x.device, extra_bytes=k2_extra_bytes(out_size))
    s0, s1 = seed_words(generator, 2)
    out = torch.empty((e, rows, out_size), dtype=torch.float32, device=x.device)
    lib = load_library()
    act, low = ACTIVATION_CODES[stack.activation], int(stack.low_precision)
    head = (s0, s1, x.data_ptr(), tiles.w.data_ptr(), stack.bs.data_ptr(),
            max_logvar.data_ptr(), min_logvar.data_ptr(), out.data_ptr(), _dims_arg(stack))
    tail = (stack.num_products, e, rows, out_size, int(sample), act, low,
            tiles.layout.member_elems)
    if not isinstance(tiles.layout, WideTileLayout):
        code = lib.mbrl_ensemble_mlp_gaussian(*head, *tail, _stream(x.device))
    else:
        scratch = _wide_scratch(tiles.layout, x.device, wide_grid(-(-rows // MAX_TILE), cluster) * e)
        code = lib.mbrl_ensemble_mlp_gaussian_wide(
            *head, _device_dims(stack.dims, x.device).data_ptr(), *tail, cluster,
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
    cluster: int = 1,
) -> torch.Tensor:
    """K1: whole-horizon imagined rollout, per-row total learned reward (B, 1).

    rot_tiles (H,) int: cumulative tile-granular rotations; obs0_rows (B, D);
    acts_rows (B, H, A); delta_mask (1, D), 1 where the target is a delta.
    Requires D == out_size - 1, tile <= 64 dividing B into a multiple of E tiles.
    ``tiles`` is ``pack_tiles(stack, k1_extra_bytes(D, out_size))`` (the
    chain's or the wide route's; K1's obs carry and normals count for the
    chain), packed here when not given. ``cluster``: the blocks of a cluster
    on the wide route, one of ``WIDE_CLUSTERS``.
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
    tiles = _check_tiles(stack, tiles, dev, extra_bytes=k1_extra_bytes(obs_dim, out_size))
    s0, s1 = seed_words(generator, 2)
    out = torch.empty((batch, 1), dtype=torch.float32, device=dev)
    lib = load_library()
    act, low = ACTIVATION_CODES[stack.activation], int(stack.low_precision)
    head = (s0, s1, rot_tiles.data_ptr(), obs0_rows.data_ptr(), acts_rows.data_ptr(),
            delta_mask.data_ptr(), tiles.w.data_ptr(), stack.bs.data_ptr(),
            max_logvar.data_ptr(), min_logvar.data_ptr(), out.data_ptr(), _dims_arg(stack))
    tail = (stack.num_products, e, batch, obs_dim, act_dim, horizon, out_size, tile,
            int(sample), act, low, tiles.layout.member_elems)
    if not isinstance(tiles.layout, WideTileLayout):
        code = lib.mbrl_rollout_returns(*head, *tail, _stream(dev))
    else:
        scratch = _wide_scratch(tiles.layout, dev, wide_grid(batch // tile, cluster),
                                carry_dim=obs_dim)
        code = lib.mbrl_rollout_returns_wide(
            *head, _device_dims(stack.dims, dev).data_ptr(), *tail, cluster, scratch.data_ptr(),
            scratch.numel(), _stream(dev),
        )
    _raise_on_error(code, "fused_rollout_returns")
    fused_rollout_returns.launches += 1
    return out


# --------------------------------------------------------------------------- #
# The SAC policy's forward (csrc/policy_mlp.cu)
# --------------------------------------------------------------------------- #
# the policy kernel's tile: rows (a cluster of two blocks, 128 rows each,
# that share each weight chunk), h2 columns, and the K rows of one ring
# chunk; its limits: linear1's K, the hidden width (h2's biases in shared
# memory) and the padded heads (a multiple of POLICY_HEAD_STEP, the kernel's
# template widths)
POLICY_ROWS = 256
POLICY_CLUSTER = 2
POLICY_COLS = 128
POLICY_CHUNK = 16
POLICY_MAX_IN = 64
POLICY_MAX_HIDDEN = 2048
POLICY_HEAD_MAX = 64
POLICY_HEAD_STEP = 16
# Rows from which GaussianPolicy.forward takes the kernel: one 256-row tile
# for each of an H100's 132 SMs (33,792 rows). The kernel is built for
# MBPO's 100,000-row rollouts, where each SM's weight chunks serve 256 rows
# at a time; its three launches and the padding to 256 rows are a fixed cost
# that only many tiles amortise. SAC's update (batch 256) and an acting step
# (one row) stay far below it.
POLICY_KERNEL_ROWS = 132 * POLICY_ROWS
# The heads' A fragment is h2's accumulators as they lie: a k-step of the
# heads' product takes the columns of an 8-column group in this order
# (csrc/policy_mlp.cu, head_fragment), and pack_policy orders the heads'
# rows to match.
HEAD_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# The other way round for linear1, whose accumulators the kernel stores as
# h1's A fragments: column p of each 8 of W1's packed tiles is h1's column
# LINEAR1_ORDER[p] (accumulator columns 2t, 2t + 1 are h1's t, t + 4).
LINEAR1_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)


@dataclasses.dataclass(frozen=True)
class PolicyPack:
    """A Gaussian policy's weights in the policy kernel's layout
    (:func:`pack_policy`): linear1's and linear2's tf32 hi/lo tiles (linear1's
    columns in :data:`LINEAR1_ORDER`), the heads ``[mean | log_std]`` as hi/lo
    tiles with their rows in :data:`HEAD_ORDER`, each bias as f32."""

    w1: torch.Tensor  # [column tile][hi | lo][core matrices of (in_pad, 128)]
    b1: torch.Tensor  # (hidden,)
    w2: torch.Tensor  # [column tile][chunk][hi | lo][core matrices of (16, 128)]
    b2: torch.Tensor  # (hidden,)
    wh: torch.Tensor  # [column tile][half][hi | lo][core matrices of (64, head_pad)]
    bh: torch.Tensor  # (2 act,)
    din: int
    act: int

    @property
    def hidden(self) -> int:
        return self.b1.shape[0]

    @property
    def in_pad(self) -> int:
        return _round_up(self.din, 8)

    @property
    def head_pad(self) -> int:
        return _round_up(2 * self.act, POLICY_HEAD_STEP)

    @property
    def col_tiles(self) -> int:
        return self.hidden // POLICY_COLS


def policy_supported(din: int, hidden: int, act: int) -> bool:
    """Whether the policy kernel takes a policy of these widths."""
    return (1 <= din <= POLICY_MAX_IN and hidden % POLICY_COLS == 0
            and POLICY_COLS <= hidden <= POLICY_MAX_HIDDEN and 1 <= 2 * act <= POLICY_HEAD_MAX)


def _tf32_pair(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3xTF32's split: tf32 hi (:func:`rna_tf32`) and the tf32 of the rest."""
    hi = rna_tf32(w)
    return hi, rna_tf32(w - hi)


def pack_policy(w1, b1, w2, b2, wm, bm, ws, bs) -> PolicyPack:
    """Pack a Gaussian policy's weights (``nn.Linear`` layouts: (out, in)
    weights) for :func:`fused_policy_mlp`; counted in
    ``fused_policy_mlp.repacks``. linear2's W2^T is cut into (column tile,
    16-row chunk) blocks, each the hi then the lo copy in ``wgmma``'s core
    matrices (K-major, as :func:`pack_chain`'s); linear1's W1^T, its K padded
    to 8 and its columns in :data:`LINEAR1_ORDER` within each 8, into
    column-tile blocks, and the heads' (hidden, 2 act) matrix, padded to
    ``head_pad`` columns and its rows in :data:`HEAD_ORDER` within each 8,
    into (column tile, 64-row half) blocks, the same way."""
    hidden, din = w1.shape
    act = wm.shape[0]
    if not policy_supported(din, hidden, act):
        raise ValueError(f"the policy kernel does not take widths in {din}, hidden {hidden}, "
                         f"act {act}")
    with torch.no_grad():
        f32 = lambda t: t.detach().float()  # noqa: E731
        nt, nc = hidden // POLICY_COLS, hidden // POLICY_CHUNK
        kp = _round_up(din, 8)
        w1t = F.pad(f32(w1).t(), (0, 0, 0, kp - din))
        w1t = w1t.reshape(kp, hidden // 8, 8)[:, :, list(LINEAR1_ORDER)]
        w1p = torch.stack(_tf32_pair(w1t.reshape(kp, hidden)))  # (copy, K, N)
        w1p = w1p.reshape(2, kp // 4, 4, nt, POLICY_COLS // 8, 8).permute(3, 0, 1, 4, 5, 2)
        w2p = torch.stack(_tf32_pair(f32(w2).t()))  # (copy, K, N)
        w2p = w2p.reshape(2, nc, 4, 4, nt, POLICY_COLS // 8, 8).permute(4, 1, 0, 2, 5, 6, 3)
        nh = _round_up(2 * act, POLICY_HEAD_STEP)
        wht = F.pad(torch.cat([f32(wm), f32(ws)]).t(), (0, nh - 2 * act))  # (hidden, nh)
        wht = wht.reshape(hidden // 8, 8, nh)[:, list(HEAD_ORDER)].reshape(hidden, nh)
        whp = torch.stack(_tf32_pair(wht)).reshape(2, nt, 2, 16, 4, nh // 8, 8)
        whp = whp.permute(1, 2, 0, 3, 5, 6, 4)
        pack = PolicyPack(w1p.contiguous().reshape(-1), f32(b1).contiguous(),
                          w2p.contiguous().reshape(-1), f32(b2).contiguous(),
                          whp.contiguous().reshape(-1), torch.cat([f32(bm), f32(bs)]), din, act)
    fused_policy_mlp.repacks += 1
    return pack


def unpack_policy(pack: PolicyPack) -> Tuple[torch.Tensor, ...]:
    """linear1's W1^T (in, hidden), linear2's W2^T (hidden, hidden) and the
    heads' (hidden, head_pad), each as (hi, lo), out of the pack's tiles
    (linear1's columns and the heads' rows back in order)."""
    h, nt, nh, kp = pack.hidden, pack.col_tiles, pack.head_pad, pack.in_pad
    w1 = pack.w1.reshape(nt, 2, kp // 4, POLICY_COLS // 8, 8, 4).permute(1, 2, 5, 0, 3, 4)
    w1 = w1.reshape(2, kp, h // 8, 8)
    lin1 = torch.empty_like(w1)
    lin1[:, :, :, list(LINEAR1_ORDER)] = w1
    lin1 = lin1.reshape(2, kp, h)[:, : pack.din]
    w2 = pack.w2.reshape(nt, h // POLICY_CHUNK, 2, 4, POLICY_COLS // 8, 8, 4)
    w2 = w2.permute(2, 1, 3, 6, 0, 4, 5).reshape(2, h, h)
    wh = pack.wh.reshape(nt, 2, 2, 16, nh // 8, 8, 4).permute(2, 0, 1, 3, 6, 4, 5)
    wh = wh.reshape(2, h // 8, 8, nh)
    heads = torch.empty_like(wh)
    heads[:, :, list(HEAD_ORDER)] = wh
    heads = heads.reshape(2, h, nh)
    return lin1[0], lin1[1], w2[0], w2[1], heads[0], heads[1]


def fused_policy_mlp_plain(x: torch.Tensor, pack: PolicyPack) -> Tuple[torch.Tensor, torch.Tensor]:
    """The policy kernel's function in plain PyTorch, its arithmetic repeated:
    linear1 and linear2 as 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi), each
    with its bias and ReLU; the heads per 128-column tile of h2 as 3xTF32,
    the tiles' partial sums added in column order, then the heads' biases
    and log_std's clamp. x (rows, in) → (mean, log_std), each (rows, act)."""
    w1_hi, w1_lo, w2_hi, w2_lo, wh_hi, wh_lo = unpack_policy(pack)
    x_hi, x_lo = _tf32_pair(x.float())
    h1 = F.relu(x_lo @ w1_hi + x_hi @ w1_lo + x_hi @ w1_hi + pack.b1)
    h1_hi, h1_lo = _tf32_pair(h1)
    h2 = F.relu(h1_lo @ w2_hi + h1_hi @ w2_lo + h1_hi @ w2_hi + pack.b2)
    heads = torch.zeros((x.shape[0], pack.head_pad), dtype=torch.float32, device=x.device)
    for n in range(pack.col_tiles):
        cols = slice(n * POLICY_COLS, (n + 1) * POLICY_COLS)
        g_hi, g_lo = _tf32_pair(h2[:, cols])
        heads = heads + (g_lo @ wh_hi[cols] + g_hi @ wh_lo[cols] + g_hi @ wh_hi[cols])
    heads = heads[:, : 2 * pack.act] + pack.bh
    return heads[:, : pack.act], heads[:, pack.act:].clamp(-20.0, 2.0)


def fused_policy_mlp(x: torch.Tensor, pack: PolicyPack) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SAC Gaussian policy's forward (``GaussianPolicy.forward``'s
    function): x (rows, in) → (mean, log_std), each (rows, act), log_std
    clamped to [-20, 2]. On the card ``csrc/policy_mlp.cu``'s three launches
    (linear1; linear2 and the heads' partial sums; the sums in order), every
    product in 3xTF32; ``pack`` is :func:`pack_policy`'s, packed once
    per weight state."""
    if not _dispatch(x):
        return fused_policy_mlp_plain(x, pack)
    from mbrl_tpu_torch.ops.build import load_library

    _check_f32(x=x)
    _check_cuda(x.device, x=x, w1=pack.w1, b1=pack.b1, w2=pack.w2, b2=pack.b2, wh=pack.wh,
                bh=pack.bh)
    if x.dim() != 2 or x.shape[1] != pack.din or x.shape[0] < 1:
        raise ValueError(f"x {tuple(x.shape)} does not match the policy's input {pack.din}")
    rows, dev = x.shape[0], x.device
    rows_pad = _round_up(rows, POLICY_ROWS)
    h1 = torch.empty(rows_pad * pack.hidden, dtype=torch.float32, device=dev)
    part = torch.empty((pack.col_tiles, rows_pad, 2 * pack.act), dtype=torch.float32, device=dev)
    mean = torch.empty((rows, pack.act), dtype=torch.float32, device=dev)
    log_std = torch.empty((rows, pack.act), dtype=torch.float32, device=dev)
    blocks = POLICY_CLUSTER * min(rows_pad // POLICY_ROWS * pack.col_tiles,
                                  sm_count(dev) // POLICY_CLUSTER)
    code = load_library().mbrl_policy_mlp(
        x.data_ptr(), pack.w1.data_ptr(), pack.b1.data_ptr(), pack.w2.data_ptr(),
        pack.b2.data_ptr(), pack.wh.data_ptr(), pack.bh.data_ptr(), h1.data_ptr(),
        part.data_ptr(), mean.data_ptr(), log_std.data_ptr(), rows, pack.din, pack.hidden,
        pack.act, blocks, _stream(dev))
    _raise_on_error(code, "fused_policy_mlp")
    fused_policy_mlp.launches += 1
    return mean, log_std


KERNEL_WRAPPERS = (fused_rollout_returns, fused_ensemble_mlp_gaussian, fused_ensemble_mlp)
for _w in KERNEL_WRAPPERS:
    _w.launches = 0
fused_ensemble_mlp.route_launches = dict.fromkeys(K3_ROUTES + K3_WIDE_ROUTES, 0)
# K3's launches that finished the Gaussian head, and GaussianMLP._forward_sharded's
# calls that kept PyTorch's gather, bound, scatter and draw around a raw head
HEAD_COUNTS = dict.fromkeys(("fused_ensemble_mlp.fused_head", "_forward_sharded.glue"), 0)
# the policy kernel's launches, its packs, and the policy calls that took
# the nn.Linear route (GaussianPolicy.forward counts them here)
POLICY_COUNTERS = ("launches", "repacks", "linear")
for _c in POLICY_COUNTERS:
    setattr(fused_policy_mlp, _c, 0)


def reset_launch_counts() -> None:
    for w in KERNEL_WRAPPERS:
        w.launches = 0
    routes = fused_ensemble_mlp.route_launches
    routes.update(dict.fromkeys(routes, 0))
    HEAD_COUNTS.update(dict.fromkeys(HEAD_COUNTS, 0))
    for c in POLICY_COUNTERS:
        setattr(fused_policy_mlp, c, 0)


def launch_counts() -> Dict[str, int]:
    """Each wrapper's launches, K3's by route under
    ``fused_ensemble_mlp.<route>`` (:data:`K3_ROUTES`, :data:`K3_WIDE_ROUTES`),
    its launches that finished the Gaussian head
    (``fused_ensemble_mlp.fused_head``) and the ``GaussianMLP._forward_sharded``
    calls that kept PyTorch's work around a raw head (``_forward_sharded.glue``),
    and the policy kernel's launches (``fused_policy_mlp``), packs
    (``fused_policy_mlp.repacks``) and the policy calls that took the
    ``nn.Linear`` route (``fused_policy_mlp.linear``)."""
    counts = {w.__name__: w.launches for w in KERNEL_WRAPPERS}
    counts.update({f"fused_ensemble_mlp.{route}": n
                   for route, n in fused_ensemble_mlp.route_launches.items()})
    counts.update(HEAD_COUNTS)
    counts["fused_policy_mlp"] = fused_policy_mlp.launches
    counts.update({f"fused_policy_mlp.{c}": getattr(fused_policy_mlp, c)
                   for c in POLICY_COUNTERS[1:]})
    return counts
