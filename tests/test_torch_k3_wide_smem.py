"""K3's resident wide route (``csrc/ensemble_mlp_wide_smem.cu``), on the CPU.

Every wide stack whose padded layers are at most 512 columns takes this
route: one 64-row tile a block, its activations resident in shared memory as
one f32 (or bf16) copy laid out by A fragment, one pass a product (each
consumer warpgroup up to 256 columns), the output written over the input,
and a ring of weight slices cut straight out of ``pack_wide``'s tiles. These
tests check, without a GPU:

- the route's pick and its shared-memory plan against the arithmetic of
  ``make_wide_smem_desc`` (``csrc/wide_tc.cuh``): 264, 300 and 512 columns
  fit in 232,448 bytes, 1,024 does not;
- the ring: the bytes the producer copies for each K slice of each product
  (a slice of every pass of a product, or in f32 whole chunks of a narrow
  one)
  cover the packed weights once, and the consumers' descriptors read the
  padded weights back out of them, each warpgroup its own columns;
- the activation buffer: a (64, k) activation written in place by the two
  warpgroups' epilogues comes back as wgmma's register fragments, and an
  f32 fragment's tf32 hi and lo are the scratch route's copies;
- the route's arithmetic, tile by tile, k-step by k-step, on those buffers
  with the in-place write and the f32 head split by K (each warpgroup every
  other k-step, the partial sums added), against the JAX kernel in
  interpret mode and, on a ragged tile the JAX kernel does not take, the
  plain version;
- the wrapper against a stand-in library: the route argument, the grid and
  no scratch.

Tolerances (|diff| <= atol + rtol |ref|): f32 1e-5 (3xTF32 drops a_lo w_lo
and rounds lo to tf32, about 2^-22 relative a product; the emulation sums in
float64, the references in float32); bf16 2e-2 against the JAX kernel (the
route rounds the input and every hidden activation to bf16, 2^-9 relative,
where the JAX kernel in interpret mode keeps them in f32) and 1e-2 against
the plain version (the same rounding points; an f32 ulp of difference can
flip one bf16 rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mbrl_tpu.models.gaussian_mlp import _ACTIVATIONS
from mbrl_tpu.ops import pallas_kernels as pk
from mbrl_tpu_torch.ops import kernels as tk
from test_torch_kernel_layout import _pair_fragments, _slot
from test_torch_wide_route import _stack, fake_card  # noqa: F401 (a fixture)

SMEM_LIMIT = 232_448
DIMS = {
    "w264": (24, 264, 264, 36),
    "w300": (24, 300, 300, 36),
    "w512": (23, 512, 512, 512, 512, 36),
    "deep12": (24,) + (64,) * 11 + (36,),  # 12 products
    "w1024": (24, 1024, 1024, 36),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _c_plan(dims, low_precision):
    """``make_wide_smem_desc`` step by step: (ring buffers, shared memory
    bytes), or None where it refuses the stack."""
    kstep, esize, copies = (16, 2, 1) if low_precision else (8, 4, 2)
    up = lambda x, m: (x + m - 1) // m * m  # noqa: E731
    products = len(dims) - 1
    kmax = nmax = n1max = 0
    for i in range(products):
        kmax = max(kmax, up(dims[i], kstep))
        n = up(dims[i + 1], kstep if i + 1 < products else 8)
        nmax = max(nmax, n)
        n1max = max(n1max, n if n <= 256 and not low_precision else 0)
    if nmax > 2 * 256:
        return None
    split = not low_precision and n <= 40  # n: the head's
    a_bytes = max(64 * kmax * esize, 4 * 64 * n if split else 0)
    chunk = 64 if low_precision else 16
    stage = max((32 if low_precision else 8) * nmax, chunk * n1max) * esize * copies
    free = SMEM_LIMIT - 128 - a_bytes - 4 * nmax
    stages = min(4, max(free, 0) // stage)
    if stages < 3:
        return None
    return stages, 128 + a_bytes + stages * stage + 4 * nmax


@pytest.mark.parametrize("dt", list(DTYPES))
def test_the_plan_mirrors_make_wide_smem_desc(dt):
    low = dt == "bf16"
    sweep = [DIMS[n] for n in DIMS] + [
        (5, w, w, 8) for w in (8, 100, 257, 320, 400, 496, 504, 512, 513, 520, 600)] + [
        (600, 512, 36), (1000, 64, 36), (24, 512, 600), (24, 256, 1024, 36)]
    for dims in sweep:
        lay = tk.WideTileLayout(dims, low)
        plan = _c_plan(dims, low)
        assert lay.k3_resident == (plan is not None), dims
        if plan is not None:
            assert (lay.k3_stages, lay.k3_smem_bytes) == plan, dims
            assert lay.k3_smem_bytes <= tk.TC_SMEM_BYTES == SMEM_LIMIT
    for name in ("w264", "w300", "w512", "deep12"):
        assert tk.WideTileLayout(DIMS[name], low).k3_resident
        assert not tk.takes_chain(DIMS[name], low)  # the wide route's, not the chain's
    assert not tk.WideTileLayout(DIMS["w1024"], low).k3_resident


@pytest.mark.parametrize("dt,stages,smem", [("f32", 3, 231_552), ("bf16", 4, 198_784)])
def test_the_plan_at_4x512(dt, stages, smem):
    """f32: a 128 KB activation buffer, three 32 KB ring buffers and 2 KB of
    biases leave 896 of the 232,448 bytes; bf16: 64 KB and four buffers."""
    lay = tk.WideTileLayout(DIMS["w512"], dt == "bf16")
    assert lay.k3_a_bytes == (65_536 if dt == "bf16" else 131_072)
    assert lay.k3_stage_bytes == 32_768 and lay.k3_stages == stages
    assert lay.k3_smem_bytes == smem == 128 + lay.k3_a_bytes + stages * 32_768 + 2_048


def _split(lay, i):
    """Whether product i is a head split by K over the two warpgroups."""
    return i == len(lay.dims) - 2 and lay.k3_head_split


def _columns(lay, i, wg):
    hidden = i + 1 < len(lay.dims) - 1
    return tk.k3_columns(lay.n_pad[i], wg, 2 if lay.low_precision and hidden else 1,
                         _split(lay, i))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["w264", "w300", "w512", "deep12"])
def test_each_warpgroup_takes_at_most_one_pass(name, dt):
    lay = tk.WideTileLayout(DIMS[name], dt == "bf16")
    assert lay.k3_head_split == (dt == "f32")  # a head of 36 columns, padded to 40
    for i in range(len(lay.dims) - 1):
        cols = [_columns(lay, i, wg) for wg in (0, 1)]
        if _split(lay, i):  # both warpgroups every column, each half of the k-steps
            assert cols == [(0, lay.n_pad[i], 0, lay.n_pad[i] // 8)] * 2
            continue
        spans = [(p0 + nw, p0 + nw + 8 * n8) for p0, _, nw, n8 in cols]
        assert spans[0][0] == 0 and spans[0][1] == spans[1][0] and spans[1][1] == lay.n_pad[i]
        for (p0, w, nw, n8), (start, _) in zip(cols, spans):
            assert (p0, w) in lay.passes(i) and 0 <= n8 <= 32 and nw + 8 * n8 <= w
            hidden = i + 1 < len(lay.dims) - 1
            if lay.low_precision and hidden:  # a bf16 fragment's 16 columns stay in one warpgroup
                assert start % 16 == 0
    if name in ("w264", "w300"):  # the halves differ: pass 1 is narrow
        assert _columns(lay, 1, 0)[3] == 32 and _columns(lay, 1, 1)[3] < 8


def _ring_b(buf, lay, i, k, sl, cols, copy, local):
    """A warpgroup's B operand of product i's k-step ``local`` of the ring
    buffer of ``sl`` K rows from row k, as its descriptors read it
    (``k3_step``). Two passes: the pass's slice at sl * p0 * copies elements,
    its copy ``copy`` sl * w further. One pass: chunk c = local / (k-steps a
    chunk) at c * chunk * n_pad * copies, its copy ``copy`` kc * n_pad
    further (kc its K rows), then the k-step in the chunk. Either way
    K-adjacent core matrices w * t elements apart, N-adjacent 8 t, the
    warpgroup's columns nw * t in. Returns (KSTEP, 8 * n8)."""
    p0, w, nw, n8 = cols
    t, kstep = lay.t, 16 if lay.low_precision else 8
    if lay.n_pad[i] > tk.WIDE_PASS or lay.low_precision:
        base = sl * p0 * lay.copies + copy * sl * w + local * 2 * w * t + nw * t
    else:
        per = lay.chunk // kstep
        c = local // per
        kc = min(lay.chunk, lay.k_pad[i] - k - c * lay.chunk)
        base = (c * lay.chunk * w * lay.copies + copy * kc * w + (local - c * per) * 2 * w * t
                + nw * t)
    kk, n = np.meshgrid(np.arange(kstep), np.arange(8 * n8), indexing="ij")
    return buf[base + kk // t * w * t + n // 8 * 8 * t + n % 8 * t + kk % t]


def _ring_buffers(tiles, member=0):
    """Each ring buffer's contents as the producer lands them
    (``kernels.k3_ring_copies``): (product, first K row, K rows, elements)."""
    lay = tiles.layout
    w = tiles.w[member].float().numpy()
    out = []
    for i, k, copies in tk.k3_ring_copies(lay):
        buf = np.full(lay.k3_stage_bytes // lay.esize, np.nan, np.float32)
        for src, dst, n in copies:
            buf[dst:dst + n] = w[src:src + n]
        out.append((i, k, min(lay.k3_rows(i), lay.k_pad[i] - k), buf))
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["w264", "w300", "w512", "deep12"])
def test_the_ring_slices_reassemble_the_packed_weights(name, dt):
    dims = DIMS[name]
    stack = _stack(dims, DTYPES[dt], seed=3, e=1)
    tiles = tk.pack_wide(stack)
    lay = tiles.layout
    kstep = 16 if lay.low_precision else 8
    # the copies of each product cover its packed elements once
    ring = tk.k3_ring_copies(lay)
    for i in range(stack.num_products):
        spans = sorted((src, src + n) for p, _, copies in ring if p == i for src, _, n in copies)
        assert spans[0][0] == lay.product_offset(i) and spans[-1][1] == lay.product_offset(i + 1)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(sum(n for _, _, n in c) * lay.esize <= lay.k3_stage_bytes for _, _, c in ring)
    # an f32 one-pass product's buffers hold whole chunks, an even number of
    # k-steps but its last (a split head's pairs never straddle two buffers);
    # the others wt_slice rows
    for i in range(stack.num_products):
        if lay.n_pad[i] <= tk.WIDE_PASS and not lay.low_precision:
            assert lay.k3_rows(i) % lay.chunk == 0 and lay.k3_rows(i) // kstep % 2 == 0
        else:
            assert lay.k3_rows(i) == lay.k3_slice
    # and the consumers' descriptors read the padded weights out of them
    padded = [tk.unpack_chain(tiles, i) for i in range(stack.num_products)]
    for i, k, sl, buf in _ring_buffers(tiles):
        for wg in (0, 1):
            cols = _columns(lay, i, wg)
            n0 = cols[0] + cols[2]
            for copy in range(lay.copies):
                want = padded[i][copy][0].float().numpy()
                for local in range(sl // kstep):
                    got = _ring_b(buf, lay, i, k, sl, cols, copy, local)
                    rows = slice(k + local * kstep, k + (local + 1) * kstep)
                    np.testing.assert_array_equal(got, want[rows, n0:n0 + 8 * cols[3]])


def _bf16(v):
    return torch.tensor(np.asarray(v, np.float32)).to(torch.bfloat16).float().numpy()


class _ABuffer:
    """The resident activation buffer of one block: k-steps of PAIR_SLOT_BYTES,
    written as ``pair_store`` writes a lane's slot and read as
    ``pair_fragment`` gathers a lane's A fragment."""

    def __init__(self, kmax: int, low_precision: bool):
        self.low = low_precision
        self.esize = 2 if low_precision else 4
        self.kstep = 16 if low_precision else 8
        self.v = np.full(kmax // self.kstep * 2048 // self.esize, np.nan, np.float32)

    def store(self, q, warp, lane, vals):
        off = _slot(q, warp, lane) // self.esize
        if self.low:  # (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1) of groups 2q, 2q + 1
            self.v[off:off + 8] = _bf16(vals)
        else:  # float4(v0, v2, v1, v3): (r, c), (r + 8, c), (r, c + 1), (r + 8, c + 1)
            self.v[off:off + 4] = [vals[0], vals[2], vals[1], vals[3]]

    def fragment(self, q, warp, lane):
        if self.low:
            off = _slot(q, warp, lane) // 2
            return list(self.v[off:off + 8])
        t, g4 = lane % 4, lane & ~3
        p = _slot(q, warp, g4 + t // 2) // 4 + 2 * (t & 1)
        s = _slot(q, warp, g4 + 2 + t // 2) // 4 + 2 * (t & 1)
        return [self.v[p], self.v[p + 1], self.v[s], self.v[s + 1]]

    def dense(self, k):
        """A (64, k) as the k-steps' fragments hold it."""
        a = np.full((64, k), np.nan, np.float32)
        for q in range(k // self.kstep):
            for warp in range(4):
                for lane in range(32):
                    r, t = 16 * warp + lane // 4, lane % 4
                    f = self.fragment(q, warp, lane)
                    if self.low:
                        c = 16 * q + 2 * t
                        (a[r, c], a[r, c + 1], a[r + 8, c], a[r + 8, c + 1], a[r, c + 8],
                         a[r, c + 9], a[r + 8, c + 8], a[r + 8, c + 9]) = f
                    else:
                        c = 8 * q + t
                        a[r, c], a[r + 8, c], a[r, c + 4], a[r + 8, c + 4] = f
        return a

    def write_columns(self, y, n0, n8):
        """A warpgroup's epilogue in place: its (64, 8 n8) block y of columns
        from n0 on, lane by lane as its D fragment holds them (rows r and r +
        8, columns c and c + 1 of each group), into k-steps from n0 / KSTEP
        on (``pair_epilogue``)."""
        per = 2 if self.low else 1
        for warp in range(4):
            for lane in range(32):
                r, c0 = 16 * warp + lane // 4, 2 * (lane % 4)
                for j in range(0, n8, per):
                    vals = []
                    for h in range(per):
                        c = c0 + 8 * (j + h)
                        vals += [y[r, c], y[r, c + 1], y[r + 8, c], y[r + 8, c + 1]]
                    self.store(n0 // self.kstep + j // per, warp, lane, vals)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_the_in_place_buffer_gives_wgmma_fragments(dt):
    low = dt == "bf16"
    lay = tk.WideTileLayout(DIMS["w300"], low)
    k = lay.n_pad[0]  # 304: warpgroup 0 256 columns, warpgroup 1 48
    rng = np.random.default_rng(4)
    y = rng.standard_normal((64, k)).astype(np.float32)
    if low:
        y = _bf16(y)
    buf = _ABuffer(max(lay.k_pad), low)
    for wg in (0, 1):
        p0, _, nw, n8 = _columns(lay, 0, wg)
        buf.write_columns(y[:, p0 + nw:p0 + nw + 8 * n8], p0 + nw, n8)
    np.testing.assert_array_equal(buf.dense(k), y)
    want = _pair_fragments(y.astype(np.float64), low)
    for (q, warp, lane), vals in want.items():
        assert buf.fragment(q, warp, lane) == [np.float32(v) for v in vals]
    if not low:  # the fragment's hi and lo, split in registers, are the scratch route's copies
        a = torch.from_numpy(buf.dense(k))
        hi = tk.rna_tf32(a)
        scratch_hi, scratch_lo = tk.rna_tf32(torch.from_numpy(y)), None
        scratch_lo = tk.rna_tf32(torch.from_numpy(y) - scratch_hi)
        assert torch.equal(hi, scratch_hi) and torch.equal(tk.rna_tf32(a - hi), scratch_lo)


def _emulated_resident_k3(x: torch.Tensor, stack: tk.MLPStack) -> torch.Tensor:
    """K3's resident route on the CPU: per member, per 64-row tile, the input
    staged into the activation buffer (zero rows past the tile's end), then
    per product each warpgroup's columns k-step by k-step on its fragments
    (f32 split into tf32 hi and lo: a_lo w_hi + a_hi w_lo + a_hi w_hi, summed
    in float64) and on B read out of the ring buffers the producer lands;
    both warpgroups' products before either epilogue writes over the input
    (bias, activation, zero past dout, bf16 rounding in the store); the head
    from registers to the output, masked to the tile's rows."""
    tiles = tk.pack_wide(stack)
    lay, low = tiles.layout, stack.low_precision
    act = tk.ACTIVATIONS[stack.activation]
    kstep = 16 if low else 8
    e_, rows_, din = x.shape
    dh, products = stack.dims[-1], stack.num_products
    out = torch.zeros((e_, rows_, dh))
    for m in range(e_):
        ring = _ring_buffers(tiles, m)
        biases = [stack.product(i)[1][m, 0].numpy() for i in range(products)]
        for row0 in range(0, rows_, 64):
            rows = min(64, rows_ - row0)
            buf = _ABuffer(max(lay.k_pad), low)
            tile = np.zeros((64, lay.k_pad[0]), np.float32)
            tile[:rows, :din] = x[m, row0:row0 + rows].numpy()
            buf.write_columns(tile, 0, lay.k_pad[0] // 8)
            for i in range(products):
                hidden = i + 1 < products
                a = torch.from_numpy(buf.dense(lay.k_pad[i])).double()
                split = _split(lay, i)
                done = []
                for wg in (0, 1):  # both products before either epilogue
                    cols = _columns(lay, i, wg)
                    acc = torch.zeros((64, 8 * cols[3]), dtype=torch.float64)
                    for p, k, sl, rbuf in ring:
                        if p != i:
                            continue
                        for local in range(sl // kstep):
                            if split and (k // kstep + local) % 2 != wg:  # the other's k-step
                                continue
                            ak = a[:, k + local * kstep:k + (local + 1) * kstep]
                            bs = [torch.from_numpy(_ring_b(rbuf, lay, i, k, sl, cols, c, local)).double()
                                  for c in range(lay.copies)]
                            if low:
                                acc += ak @ bs[0]
                            else:
                                a_hi = tk.rna_tf32(ak.float()).double()
                                a_lo = tk.rna_tf32((ak - a_hi).float()).double()
                                acc += a_lo @ bs[0] + a_hi @ bs[1] + a_hi @ bs[0]
                    done.append((cols, acc.float()))
                if split:  # warpgroup 1's partial sums added by warpgroup 0
                    done = [(done[0][0], done[0][1] + done[1][1])]
                dout = stack.dims[i + 1]
                for (p0, _, nw, n8), d in done:
                    n0 = p0 + nw
                    b = torch.from_numpy(np.pad(biases[i], (0, lay.n_pad[i] - dout)))
                    v = d + b[n0:n0 + 8 * n8]
                    if hidden:
                        v = act(v)
                        v[:, max(0, dout - n0):] = 0.0
                        buf.write_columns(v.numpy(), n0, n8)
                    else:
                        c1 = min(n0 + 8 * n8, dh)
                        if c1 > n0:
                            out[m, row0:row0 + rows, n0:c1] = v[:rows, :c1 - n0]
    return out


def _jax_k3(x: np.ndarray, stack: tk.MLPStack) -> np.ndarray:
    layers = [stack.product(i) for i in range(stack.num_products)]
    ref = pk.fused_ensemble_mlp(
        jnp.asarray(x), tuple(jnp.asarray(w.float().numpy()) for w, _ in layers[:-1]),
        tuple(jnp.asarray(b.numpy()) for _, b in layers[:-1]),
        jnp.asarray(layers[-1][0].float().numpy()), jnp.asarray(layers[-1][1].numpy()),
        activation=_ACTIVATIONS[stack.activation], tile=8, interpret=True)
    return np.asarray(ref, np.float32)


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_emulated_route_matches_the_jax_kernel(dt, tol):
    """2 members x 72 rows (a full tile and an 8-row one) x 300 wide: the
    warpgroups' halves differ (256 and 48 columns of a hidden product)."""
    e, dims = 2, DIMS["w300"]
    stack = _stack(dims, DTYPES[dt], seed=14, e=e)
    x = np.random.default_rng(15).standard_normal((e, 72, dims[0])).astype(np.float32)
    if dt == "bf16":  # the route rounds its input to bf16; so does the JAX kernel's caller
        x = _bf16(x)
    got = _emulated_resident_k3(torch.from_numpy(x), stack)
    np.testing.assert_allclose(got.numpy(), _jax_k3(x, stack), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 1e-2)])
@pytest.mark.parametrize("name", ["w264", "deep12"])
def test_emulated_route_on_a_ragged_tile_matches_the_plain_version(name, dt, tol):
    """70 rows a member (the JAX kernel takes no ragged tile): 264 wide, where
    warpgroup 1 takes 8 columns of a hidden product, and a 12-product chain."""
    e, dims = 2, DIMS[name]
    stack = _stack(dims, DTYPES[dt], seed=16, e=e, activation="tanh")
    x = torch.from_numpy(np.random.default_rng(17).standard_normal((e, 70, dims[0])).astype(np.float32))
    got = _emulated_resident_k3(x, stack)
    torch.testing.assert_close(got, tk.fused_ensemble_mlp_plain(x, stack), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name,rows", [("w264", 100), ("w300", 2_017), ("w512", 20_000),
                                       ("deep12", 64), ("w1024", 100)])
def test_the_wrapper_passes_the_route_its_grid_and_no_scratch(fake_card, name, rows, dt):
    dims = DIMS[name]
    stack = _stack(dims, DTYPES[dt], e=5)
    tiles = tk.pack_wide(stack)
    lay = tiles.layout
    out = tk.fused_ensemble_mlp(torch.zeros((5, rows, dims[0])), stack, tiles=tiles)
    assert out.shape == (5, rows, dims[-1])
    ((entry, args),) = fake_card.calls
    assert entry == "mbrl_ensemble_mlp_wide" and args[1] == tiles.w.data_ptr()
    assert args[6:12] == (stack.num_products, 5, rows, tk.persistent_blocks(rows, 5, 132),
                          tk.ACTIVATION_CODES["silu"], int(stack.low_precision))
    assert args[12] == lay.member_elems
    if name == "w1024":
        assert args[-2] == tk.K3_WIDE_ROUTES.index("scratch")
        assert args[-3] == args[9] * lay.block_bytes()
    else:
        assert args[-2] == tk.K3_WIDE_ROUTES.index("smem") and args[-4] is None and args[-3] == 0
    assert tk.launch_counts()["fused_ensemble_mlp"] == 1
