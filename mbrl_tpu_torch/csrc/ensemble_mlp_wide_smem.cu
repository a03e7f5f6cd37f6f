// K3's wide route with a tile's activations resident in shared memory
// (sm_90a), written by hand: ensemble_mlp_wide_smem_kernel.
//
// Replaces the Pallas TPU kernel fused_ensemble_mlp / _kernel of
// mbrl_tpu/ops/pallas_kernels.py (member m runs its own MLP chain over its own
// contiguous shard of rows; the head comes out raw) for every stack that the
// chain (ensemble_mlp.cu) does not take and whose widest padded layer is at
// most 512 columns (make_wide_smem_desc, mirrored by
// ops/kernels.py:WideTileLayout.k3_resident): the 264-, 300- and 512-wide
// models and deep narrow chains. The entry mbrl_ensemble_mlp_wide
// (ensemble_mlp_wide.cu) launches it, or ensemble_mlp_wide_tc_kernel for the
// wider stacks. It is the step of ModelEnv.step ->
// GaussianMLP._forward_sharded for a wide model, from a planner's 8,000 rows
// to a policy-training rollout's 100,000.
//
// What bounds it: operations, the products at the tensor peak (bf16 989
// TFLOP/s; an f32 stack as 3xTF32, three tf32 products at 495). At 4 x 512 a
// row costs 816,640 MACs against 23-24 input and 36 output floats; a
// member's stack (1.6 MB bf16, 6.5 MB as tf32 hi/lo pairs) is read from L2
// by every tile. What held the scratch route below half of that: a tile's
// activations made a round trip through a per-block scratch in device
// memory at every product, f32 as tf32 hi and lo copies streamed back once
// per 256-column pass (about 4.4 GB through L2 a launch at 100,000 rows), and
// 132 blocks' f32 scratch (70.6 MB) outgrew L2's 50 MB beside the weights.
// This route, at 100,000 rows on an H100, reaches 56% of the bound in f32
// and 27% in bf16: the register-A products, the epilogues (about a tenth of
// a tile) and the head take the rest (PERF.md).
//
// Design: no activation touches device memory.
// - Persistent blocks, one 64-row tile at a time, walking the member-major
//   (member, tile) list as the scratch route does (persistent_blocks and
//   block_tiles in ops/kernels.py); TC_CHAIN_THREADS threads: two consumer
//   warpgroups (setmaxnreg: 240 registers) and a producer warpgroup (24)
//   whose first thread streams the weights.
// - One pass a product: warpgroup w takes pass w of a product wider than 256
//   columns, or its share of a narrower one (k3_cols), up to 256 columns and
//   128 f32 accumulators a thread, one wgmma of its width a k-step.
// - One activation buffer a tile, resident: 64 x kmax, one f32 (or bf16) copy
//   laid out by A fragment (pair_slot; 128 KB f32 at 512 columns). A comes
//   from registers (wgmma_rs.cuh): each k-step's fragment is loaded before
//   its wgmma, and an f32 one split there into tf32 hi and lo for the three
//   products of 3xTF32 (a_lo w_hi + a_hi w_lo + a_hi w_hi), as K3's two-tile
//   route does. bf16 takes A from registers too: one code path, its
//   fragment a single 16-byte load (A from shared memory was not tried).
// - The epilogue writes a product's output over its input. The whole product
//   is in registers first; both warpgroups have read the input once every
//   thread is past wgmma_wait<0> and a consumer barrier, and a second barrier
//   hands the new input on. Both are plain shared-memory loads and stores,
//   so no proxy fence is needed.
// - A ring of weights only, cut straight out of pack_wide's tiles
//   (k3_rows): a ring buffer holds wt_slice K rows (8 f32, 32 bf16) of every
//   pass of a product, one bulk copy a pass and copy (in the tiles' K-major
//   layout the rows of a chunk's copy are contiguous); in f32 it holds as
//   many whole chunks of a one-pass product as fit, one bulk copy (its
//   chunks are contiguous), so that a narrow head takes a few ring round
//   trips, not one a k-step. The producer never waits for activations, so it
//   runs ahead across products and into the next tile.
// - Biases: one product's in shared memory, each thread's two loaded from
//   device memory before the products and stored after the barrier that
//   ends the previous epilogue.
// - The head: in f32, at most TC_HEAD_SPLIT (padded) columns are split by K,
//   as the chain's head: both warpgroups take every column, warpgroup w the
//   k-steps w, w + 2, ..., which halves each one's run of short dependent
//   wgmma (24.7 -> 10.8 us of a 145 us tile at 4 x 512 on an H100);
//   warpgroup 1 leaves its partial sums in the activation buffer (free once
//   both have read it) for warpgroup 0, which adds them and the bias. A bf16
//   head, and a wider one, is split by columns as any product (k3_step says
//   why). The head goes straight from registers to `out` (a tile's rows are
//   contiguous there); the ragged last tile is masked on input (zero rows)
//   and output. A barrier after it, then the consumers stage the next tile's
//   input.
// - Every loop bound is block-uniform (blockIdx, gridDim, the arguments, the
//   dims through uniform(), the warpgroup index), and a commit group holds
//   one k-step, two in flight: ptxas serializes register-A wgmma otherwise.
// - Compiled per dtype only, the activation a switch around the epilogue
//   (pair_epilogue): the products of 32 widths are the bulk of the code.
//
// The entry returns cudaGetLastError() after the launch (ensemble_mlp_wide.cu).

#include "wgmma_rs.cuh"
#include "wide_tc.cuh"

#define K3S_IN_FLIGHT 2  // k-steps in flight a warpgroup

#ifdef TC_TIMELINE
// Marks of block 0 (warpgroup 1's at 32 + k, the producer's at 64 + k): 0
// start, 1 barriers set up; of the last tile it ran, 29 tile begun, 2 input
// staged and, for product i at j = k3_mark(i), j its first ring buffer
// landed, j + 1 its products done, j + 2 its epilogue written (the head: to
// out), j + 3 the barrier after it passed; 30 the tile done. The producer: j
// product i's copies begun, j + 1 its last issued; at 29 the ns it waited on
// empty barriers during product 1 (a duration). Read, then zeroed.
extern "C" int mbrl_timeline_k3_wide_smem(unsigned long long* out) {
  static const unsigned long long zero[96] = {};
  const cudaError_t err = cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(tc_timeline, zero, sizeof(zero));
}
#endif

// product i's first timeline mark (four a product, the first six products)
__device__ __forceinline__ int k3_mark(int i) { return 3 + 4 * min(i, 5); }

// Where a warpgroup's columns of a product np wide lie: pass p0 of width w
// (its B layout in the ring), nw columns into it, n8 8-column groups. Two
// passes: warpgroup wg takes pass wg. One: warpgroup 0 the first half of the
// groups, in units of `unit` groups (2 for a bf16 hidden layer, whose A
// fragment holds 16 columns), warpgroup 1 the rest; a head split by K
// (`split`): both every column. Mirrors ops/kernels.py:k3_columns.
struct K3Cols {
  int p0, w, nw, n8;
};

__device__ __forceinline__ K3Cols k3_cols(int np, int wg, int unit, bool split) {
  if (np > WT_PASS) {
    const int w = wg ? np - WT_PASS : WT_PASS;
    return {wg * WT_PASS, w, 0, w / 8};
  }
  if (split) return {0, np, 0, np / 8};
  const int half = (np / 8 / unit + 1) / 2 * unit;
  return {0, np, wg ? 8 * half : 0, wg ? np / 8 - half : half};
}

// K rows of one ring buffer of a product np wide: wt_slice of every pass, or
// in f32 as many whole chunks of a one-pass product as a ring buffer holds.
// Mirrors ops/kernels.py:WideTileLayout.k3_rows.
template <bool BF16>
__device__ __forceinline__ int k3_rows(const WideDesc& d, int np) {
  using C = TC<BF16>;
  if (BF16 || np > WT_PASS) return wt_slice<BF16>();
  return d.stage_bytes / (C::CHUNK * np * C::ESIZE * C::COPIES) * C::CHUNK;
}

// This thread's two of a product's (at most 2 x TC_CONSUMERS) biases: loaded,
// and stored into the block's copy
__device__ __forceinline__ void load_bias2(float* v, const float* __restrict__ b, int n) {
  const int t = threadIdx.x;
  v[0] = t < n ? __ldg(b + t) : 0.0f;
  v[1] = t + TC_CONSUMERS < n ? __ldg(b + t + TC_CONSUMERS) : 0.0f;
}

__device__ __forceinline__ void store_bias2(float* s, const float* v, int n) {
  const int t = threadIdx.x;
  if (t < n) s[t] = v[0];
  if (t + TC_CONSUMERS < n) s[t + TC_CONSUMERS] = v[1];
}

// Streams one chain of member `wm` (pack_wide's tiles) through the ring, per
// product k3_rows K rows a ring buffer: those rows of each pass, pass after
// pass, each its copies (f32: hi, lo), one bulk copy a pass and copy; of an
// f32 one-pass product whole chunks, one bulk copy. Every loop bound is the
// consumers'.
template <bool BF16>
__device__ void produce_k3_smem(const WideDesc& d, const int* __restrict__ dims, uint32_t bars,
                                const unsigned char* wm, uint32_t& it) {
  using C = TC<BF16>;
  const uint32_t stage0 = bars + WT_BARRIER_BYTES + (uint32_t)d.a_buf_bytes;
  const unsigned char* prod = wm;  // product i's tiles
  unsigned long long waited = 0;   // the timeline's: ns waited on empty barriers
  for (int i = 0; i < d.num_products; ++i) {
    const bool hidden = i + 1 < d.num_products;
    const int kp = wt_round_up(__ldg(dims + i), C::KSTEP);
    const int np = wt_round_up(__ldg(dims + i + 1), hidden ? C::KSTEP : 8);
    const int rows = k3_rows<BF16>(d, np);
    TC_STAMP(k3_mark(i))
    for (int k = 0; k < kp; k += rows) {
      const int sl = min(rows, kp - k);
      const int k0 = k / C::CHUNK * C::CHUNK, kc = min(C::CHUNK, kp - k0);
      const int s = it % d.stages;
      wait_free(bars + 64 + 8 * s, ((it / d.stages) & 1) ^ 1, i == 1, waited);
      mbar_expect_tx(bars + 8 * s, (uint32_t)(sl * np * C::ESIZE * C::COPIES));
      uint32_t dst = stage0 + s * d.stage_bytes;
      if (!BF16 && np <= WT_PASS) {  // whole chunks of one pass: one run of the tiles
        bulk_load(dst, prod + (size_t)k * np * C::COPIES * C::ESIZE, sl * np * C::ESIZE * C::COPIES,
                  bars + 8 * s);
        ++it;
        continue;
      }
      for (int p0 = 0; p0 < np; p0 += WT_PASS) {
        const int w = min(WT_PASS, np - p0);
        // rows [k, k + sl) of the chunk at k0 of the pass at p0: its copy c
        // starts c * kc * w elements in, and a copy's rows are w elements apart
        const unsigned char* src =
            prod + ((size_t)p0 * kp * C::COPIES + (size_t)k0 * w * C::COPIES + (size_t)(k - k0) * w) *
                       C::ESIZE;
        for (int c = 0; c < C::COPIES; ++c) {
          bulk_load(dst, src + (size_t)c * kc * w * C::ESIZE, sl * w * C::ESIZE, bars + 8 * s);
          dst += sl * w * C::ESIZE;
        }
      }
      ++it;
    }
    prod += (size_t)kp * np * C::COPIES * C::ESIZE;
    TC_STAMP(k3_mark(i) + 1)
  }
  TC_RECORD(64 + 29, waited)
}

// Where the consumers are in the ring, counted over the launch (both
// warpgroups take every buffer): buffers taken, the current one, the previous
// one (freed once its products are done).
struct K3Ring {
  uint32_t it;
  int s, prev;
};

// A product as the consumers take it: its K and N, k-steps, k-steps a ring
// buffer, and whether it is a head split by K.
struct K3Prod {
  int kp, np, steps, spb;
  bool split;
};

// Where the consumers are in a product: the units left in the current ring
// buffer, its first K row, and the k-step in it of the next unit's first.
struct K3Pos {
  int left, kb, l0;
};

// Unit u of a product on this warpgroup: k-step u, or of a head split by K
// the pair of k-steps 2u and 2u + 1, warpgroup wg's the (2u + wg)-th (none
// past the product's last: an empty commit group keeps both warpgroups'
// counts alike). Waits for its ring buffer if the unit is the buffer's first
// (a buffer holds whole pairs), loads the fragment into `f` and issues the
// products on this warpgroup's columns as one commit group; once the group
// before it is done, frees the previous buffer if u began a new one.
//
// bf16 takes every product in wt_slice rows a buffer, a count the compiler
// knows, and splits no head: its 512-wide k-steps are short, and on an H100
// every addition to this loop cost more than the head gained (a place in the
// buffer counted at run time: the k-steps 35% slower; a second loop for the
// head: every epilogue 60% slower). f32 counts the place (`pos`): no
// division by a count the compiler does not know.
template <bool BF16>
__device__ __forceinline__ void k3_step(const WideDesc& d, uint32_t bars, int u, const K3Prod& p,
                                        const K3Cols& cols, int wg, float* acc, uint32_t* f,
                                        const unsigned char* abuf, int warp, int lane, int mark,
                                        K3Ring& ring, K3Pos& pos) {
  using C = TC<BF16>;
  constexpr int SPB = wt_slice<BF16>() / C::KSTEP;  // bf16: k-steps a ring buffer
  const bool begin = BF16 ? u % SPB == 0 : pos.left == 0;
  if (begin) {
    if constexpr (!BF16) {
      pos.kb += u == 0 ? 0 : p.spb * C::KSTEP;
      pos.left = p.split ? p.spb / 2 : p.spb;
      pos.l0 = 0;
    }
    ring.s = ring.it % d.stages;
    mbar_wait(bars + 8 * ring.s, (ring.it / d.stages) & 1);
    TC_STAMP_IF(mark, u == 0)
  }
  const int q = p.split ? 2 * u + wg : u;
  const int l = BF16 ? u % SPB : pos.l0 + (p.split ? wg : 0);  // q's k-step in the buffer
  const int kb = BF16 ? (u - l) * C::KSTEP : pos.kb;             // the buffer's first K row
  const uint32_t st = bars + WT_BARRIER_BYTES + (uint32_t)d.a_buf_bytes + ring.s * d.stage_bytes;
  uint32_t b, b_lo, b_lbo;
  if (BF16 || p.np > WT_PASS) {  // the pass's slice follows the earlier pass's (256 columns, every copy)
    const int sl = min(wt_slice<BF16>(), p.kp - kb);
    b_lbo = cols.w * 16;
    b = st + sl * cols.p0 * C::ESIZE * C::COPIES + l * 2 * b_lbo + cols.nw * 16;
    b_lo = b + sl * cols.w * C::ESIZE;
  } else {  // chunk c of the buffer, its hi then lo copy
    constexpr int SPC = C::CHUNK / C::KSTEP;
    const int c = l / SPC, kc = min(C::CHUNK, p.kp - kb - c * C::CHUNK);
    b_lbo = p.np * 16;
    b = st + c * C::CHUNK * p.np * C::ESIZE * C::COPIES + (l - c * SPC) * 2 * b_lbo + cols.nw * 16;
    b_lo = b + kc * p.np * C::ESIZE;
  }
  const bool has = q < p.steps;
  pair_step<BF16>(has ? cols.n8 : 0, u == 0, acc, f, abuf, has ? q : q - 1, warp, lane, b, b_lo,
                  b_lbo);
  wgmma_wait<K3S_IN_FLIGHT - 1>();
  if (begin) {
    mbar_arrive(bars + 64 + 8 * max(ring.prev, 0), lane == 0 && ring.prev >= 0);
    ring.prev = ring.s;
    ++ring.it;
  }
  if constexpr (!BF16) {
    pos.l0 += p.split ? 2 : 1;
    --pos.left;
  }
}

// A product on this warpgroup's columns, A from the resident buffer, into
// acc; its units in pairs over two fragment sets, each written again only
// once its group is done. Ends with its last buffer freed.
template <bool BF16>
__device__ __forceinline__ void k3_product(const WideDesc& d, uint32_t bars, const K3Prod& p,
                                           const K3Cols& cols, int wg, float* acc,
                                           const unsigned char* abuf, int warp, int lane, int mark,
                                           K3Ring& ring) {
  const int units = p.split ? (p.steps + 1) / 2 : p.steps;
  uint32_t f0[8], f1[8];
  K3Pos pos{0, 0, 0};
  ring.prev = -1;
  for (int u = 0; u < units; u += 2) {
    k3_step<BF16>(d, bars, u, p, cols, wg, acc, f0, abuf, warp, lane, mark, ring, pos);
    if (u + 1 < units)
      k3_step<BF16>(d, bars, u + 1, p, cols, wg, acc, f1, abuf, warp, lane, mark, ring, pos);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 2 * ACC_REGS; ++j) asm volatile("" : "+f"(acc[j])::"memory");
  mbar_arrive(bars + 64 + 8 * ring.prev, lane == 0);
}

// grid = (blocks,), TC_CHAIN_THREADS threads; a.d is make_wide_smem_desc's
// plan. Shared memory: the barriers (full[s] at 8s, empty[s] at 64 + 8s), the
// activation buffer, the ring, one product's biases.
template <bool BF16>
__global__ void __launch_bounds__(TC_CHAIN_THREADS, 1)
ensemble_mlp_wide_smem_kernel(const K3Args a) {
  using C = TC<BF16>;
  extern __shared__ __align__(128) unsigned char smem[];
  TC_STAMP(0)
  const WideDesc& d = a.d;
  const uint32_t bars = smem_u32(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                       // full: the producer's expect_tx
      mbar_init(bars + 64 + 8 * s, TC_CONSUMERS / 32);  // empty: one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  TC_STAMP(1)
  const int wg = uniform(threadIdx.x >> 7);
  if (wg == 2) {  // the producer warpgroup: its first thread streams each tile's member
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0;
      for (int w = blockIdx.x; w < a.total; w += gridDim.x)
        produce_k3_smem<BF16>(d, a.dims, bars,
                              a.ws + (size_t)(w / a.num_tiles) * d.w_member * C::ESIZE, it);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
    unsigned char* abuf = smem + WT_BARRIER_BYTES;
    float* bias = reinterpret_cast<float*>(abuf + d.a_buf_bytes + d.stages * d.stage_bytes);
    const int din = uniform(__ldg(a.dims)), dh = uniform(__ldg(a.dims + d.num_products));
    const int steps0 = wt_round_up(din, C::KSTEP) / C::KSTEP;
    K3Ring ring{0, 0, -1};
    for (int w = blockIdx.x; w < a.total; w += gridDim.x) {
      TC_STAMP(29)
      const int e = w / a.num_tiles;
      const int row0 = (w - e * a.num_tiles) * TC_ROWS, rows = min(TC_ROWS, a.S - row0);
      const float* bm = a.bs + (size_t)e * d.b_member;
      float bn[2];  // this thread's biases of the next product
      load_bias2(bn, bm, uniform(__ldg(a.dims + 1)));
      // the input tile as the first product's A, zero past the ragged last
      // tile's rows and past `in`, the k-steps shared out between the
      // warpgroups: rows r and r + 8 of this thread's lanes
      const float* xe = a.x + ((size_t)e * a.S + row0) * din;
      for (int q = wg; q < steps0; q += 2) {
        float v[8];
#pragma unroll
        for (int h = 0; h < (BF16 ? 2 : 1); ++h) {
          const int c = (BF16 ? 16 * q : 8 * q) + 8 * h + c0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {  // (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1)
            const int rr = r + 8 * (u >> 1), cc = c + (u & 1);
            v[4 * h + u] = rr < rows && cc < din ? __ldg(xe + (size_t)rr * din + cc) : 0.0f;
          }
        }
        pair_store<BF16>(abuf, q, warp, lane, v);
      }
      store_bias2(bias, bn, uniform(__ldg(a.dims + 1)));
      consumer_sync();
      TC_STAMP(2)
      int b_off = 0;
      for (int i = 0; i < d.num_products; ++i) {
        const bool hidden = i + 1 < d.num_products;
        const int dout = uniform(__ldg(a.dims + i + 1));
        const int kp = wt_round_up(uniform(__ldg(a.dims + i)), C::KSTEP);
        const int np = wt_round_up(dout, hidden ? C::KSTEP : 8);
        const K3Prod p{kp, np, kp / C::KSTEP, k3_rows<BF16>(d, np) / C::KSTEP,
                       !BF16 && !hidden && np <= TC_HEAD_SPLIT};
        const K3Cols cols = k3_cols(np, wg, BF16 && hidden ? 2 : 1, p.split);
        const int n0 = cols.p0 + cols.nw, mark = k3_mark(i);
        const int dnext = hidden ? uniform(__ldg(a.dims + i + 2)) : 0;
        if (hidden) load_bias2(bn, bm + b_off + dout, dnext);
        float acc[2 * ACC_REGS];
        k3_product<BF16>(d, bars, p, cols, wg, acc, abuf, warp, lane, mark, ring);
        TC_STAMP(mark + 1)
        consumer_sync();  // both warpgroups have read A; this product's biases are in place
        if (hidden) {
          pair_epilogue<BF16>(a.act, acc, bias + n0, cols.n8, dout - n0,
                              abuf + n0 / C::KSTEP * PAIR_SLOT_BYTES, warp, lane);
          TC_STAMP(mark + 2)
          consumer_sync();  // the next product's A is whole, and these biases read
          TC_STAMP(mark + 3)
          store_bias2(bias, bn, dnext);
        } else {  // the raw head, straight out: rows r and r + 8, columns c and c + 1
          // split by K: warpgroup 1's partial sums through the activation
          // buffer, read by the thread of warpgroup 0 that holds the same
          // elements (none if the head has one k-step: warpgroup 1 had none)
          float* part = reinterpret_cast<float*>(abuf);
          const bool add = p.split && p.steps > 1;
          if (add && wg == 1) {
#pragma unroll
            for (int j = 0; j < TC_HEAD_SPLIT / 8; ++j) {
              if (j < cols.n8) {
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  part[(r + 8 * (u >> 1)) * np + c0 + 8 * j + (u & 1)] = acc[4 * j + u];
              }
            }
          }
          if (p.split) consumer_sync();
          if (!p.split || wg == 0) {
            float* o = a.out + ((size_t)e * a.S + row0) * dh;
#pragma unroll
            for (int j = 0; j < ACC_REGS / 2; ++j) {
              if (j < cols.n8) {
                const int c = n0 + c0 + 8 * j;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const int rr = r + 8 * (u >> 1), cc = c + (u & 1);
                  const float v = add ? acc[4 * j + u] + part[rr * np + cc] : acc[4 * j + u];
                  if (rr < rows && cc < dh) o[(size_t)rr * dh + cc] = v + bias[cc];
                }
              }
            }
          }
          TC_STAMP(mark + 2)
          consumer_sync();  // A and the head's biases are read: the next tile may overwrite them
          TC_STAMP(mark + 3)
        }
        b_off += dout;
      }
      TC_STAMP(30)
    }
  }
}

cudaError_t launch_k3_wide_smem(int bf16, dim3 grid, size_t smem, cudaStream_t stream,
                                const K3Args& a) {
  if (a.act < ACT_RELU || a.act > ACT_LEAKY_RELU) return cudaErrorInvalidValue;
  const cudaError_t err = bf16 ? prepare_once<ensemble_mlp_wide_smem_kernel<true>>()
                               : prepare_once<ensemble_mlp_wide_smem_kernel<false>>();
  if (err != cudaSuccess) return err;
  if (bf16) {
    ensemble_mlp_wide_smem_kernel<true><<<grid, TC_CHAIN_THREADS, smem, stream>>>(a);
  } else {
    ensemble_mlp_wide_smem_kernel<false><<<grid, TC_CHAIN_THREADS, smem, stream>>>(a);
  }
  return cudaSuccess;
}
