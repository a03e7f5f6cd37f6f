// The equal-shard ensemble forward K3 on Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel fused_ensemble_mlp / _kernel of
// mbrl_tpu/ops/pallas_kernels.py (member m runs its own MLP chain over its own
// contiguous shard of rows; the head comes out raw). It is the step of
// ModelEnv.step -> GaussianMLP._forward_sharded, at anything from one row a
// member (the closed loop's act-env step, the Visualizer) through a planner's
// 8,000 rows to a policy-training rollout's 100,000, and the per-step rollout
// of a deterministic head.
//
// What bounds it: operations, and at one row a member the latency of one
// member's chain. A row costs 131,800 MACs at the PETS widths against 23
// input and 36 output floats; a member's weights (264 KB bf16, 2 x 527 KB as
// tf32 hi/lo pairs) are read from L2, not device memory, after the first tile.
//
// Three routes, picked by the shape (ops/kernels.py: k3_route mirrors the
// choice, k3_blocks the grid; the entry checks both):
// - One tile a block (K3_TILE), while the (member, 64-row tile) pairs fit in
//   one wave (8,000 rows: 125 of 132 SMs). The products are K2's:
//   produce_chain() on the producer warpgroup's first thread and
//   consume_chain() on two consumer warpgroups, each half of N (tc_chain.cuh;
//   the design notes are at the top of tc_chain.cu). The work is the
//   member-major list of (member, tile) pairs; block b walks pairs b, b +
//   blocks, ... (persistent_blocks and block_tiles mirror it), with the
//   ring's chunk counter running on across tiles. The head's (64, n_pad) f32
//   tile is left at the start of the A region (a narrow head: two partial
//   tiles, added by head_at) and copied out coalesced.
// - Two tiles in flight a block (K3_PAIR), past one wave (MBPO's 80,000 and
//   100,000 rows: 12 tiles a block). Each consumer warpgroup owns a whole
//   tile, the full N of every product (up to 256 columns, 128 accumulators a
//   thread: setmaxnreg gives the consumers 240 registers and the producer
//   warpgroup 24), so a block streams a member's weights once for two
//   tiles, one wgmma covers a layer's width, and no barrier joins the two
//   warpgroups; each reads its tile's biases from its own copy in shared
//   memory (loaded per k-step group from global memory, they took 7 us an
//   f32 epilogue). The two tiles of a pair belong to one member and read one
//   weight ring (up to PAIR_MAX_STAGES buffers), each buffer freed by both;
//   on an H100 the two warpgroups run in step, so their epilogues do not
//   hide under each other's products (PERF.md). The work is
//   the member-major list of (member, tile pair); a member's odd last tile is
//   a pair of one, whose idle warpgroup still frees the ring's buffers
//   (pair_blocks and block_pairs mirror it). A comes from registers: each
//   warpgroup keeps its tile's activations in shared memory as one f32 (or
//   bf16) copy, laid out by A fragment (pair_slot), and loads each k-step's
//   fragment into registers before its wgmma; an f32 fragment is split into
//   tf32 hi and lo there, as store_a does, for the same three products
//   (3xTF32). Two f32 tiles fit only so: their hi and lo copies in shared
//   memory would take 204.8 of the 227 KB at 200 wide. The epilogue is the
//   warp's own: its rows are its wgmma rows, so only __syncwarp orders it.
//   Entered through mbrl_ensemble_mlp_head, the route works in the batch's
//   order: slot p of member e loads batch row perm[e * S + p] (the TS1
//   permutation, two indices a thread a tile), and the last epilogue
//   finishes the Gaussian head (the bias, the soft-bounded log-variance, the
//   reparameterised draw on noise drawn beforehand) and writes each result
//   to its row's place in the batch (pair_gaussian_head). The model step
//   then launches no gather, scatter or element-wise pass around K3.
// - A cluster a member (K3_CLUSTER), at a few rows a member (kernels.py:
//   CLUSTER_ROWS; the entry takes up to 64): one row per elite ran five
//   blocks on 132 SMs, each streaming its member's whole stack through one
//   SM, one 64-row tile's products and epilogues. Here a cluster of up to CLUSTER_MAX
//   blocks runs each member's chain; each block takes 1/C of every product's
//   columns, reads only those weights (the stack's plain (K, N) rows, no
//   repack) and multiplies on the FMA units (at a few real rows the tensor
//   cores' 64-row tiles buy nothing), and writes its slice of the
//   activations into every block's shared memory (st.shared::cluster), the
//   cluster meeting at a barrier before the next product. Each block writes
//   its head columns straight out.
//
// Every loop bound around a wgmma is warp-uniform (blockIdx, gridDim, kernel
// arguments, the warpgroup index through a shuffle): ptxas sees no divergent
// path around them.
//
// Plain C interface, loaded with ctypes; the entry returns cudaGetLastError()
// after its launch.

#include <limits.h>

#include <type_traits>

#include "gaussian_head.cuh"
#include "tc_chain.cuh"
#include "wgmma_rs.cuh"

#define K3_TILE 0
#define K3_PAIR 1
#define K3_CLUSTER 2
#define PAIR_MAX_STAGES 8      // full[s] at 8s, empty[s] at 64 + 8s: 128 bytes of barriers
#define PAIR_WG_BARRIER 2      // + w: warpgroup w's own named barrier
#define PAIR_IN_FLIGHT 2       // k-steps in flight a warpgroup on the two-tile route
#define CLUSTER_MAX 8
#define CLUSTER_THREADS 256
#define CLUSTER_PASS_ROWS 8    // rows of one pass of the cluster's products
#define CLUSTER_KSLICE 32      // k rows a thread holds: TC_MAX_WIDTH / 8 warps

#ifdef TC_TIMELINE
// Marks of block 0. One tile a block: 0 start, 1 barriers set up; then, of
// the last tile it ran, 29 tile begun, 2 input staged, consume_chain's 3..,
// 30 head written out. Two tiles a block: the same marks for each
// warpgroup's last tile (warpgroup 1 at 32 + k). A cluster: 2 input staged
// and the cluster met, 3 + 3i product i's columns written, 5 + 3i the
// cluster met after it, 30 head written.
extern "C" int mbrl_timeline_k3(unsigned long long* out) {
  static const unsigned long long zero[96] = {};
  const cudaError_t err = cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(tc_timeline, zero, sizeof(zero));
}
#endif

// ---------------------------------------------------------------------------
// One tile a block. grid = (blocks,), TC_CHAIN_THREADS threads. x (E, S, in)
// f32 -> out (E, S, head_out) f32, raw head; `ws` is pack_chain()'s tiles.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(TC_CHAIN_THREADS, 1)
ensemble_mlp_tc_kernel(const float* __restrict__ x, const unsigned char* __restrict__ ws,
                       const float* __restrict__ bs, float* __restrict__ out, const ChainDesc d,
                       int S, int num_tiles, int total) {
  extern __shared__ __align__(128) unsigned char smem[];
  TC_STAMP(0)
  init_barriers(d, smem);
  TC_STAMP(1)
  if (__shfl_sync(0xffffffffu, threadIdx.x, 0) >= TC_CONSUMERS) {  // the producer warpgroup
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0;
      for (int w = blockIdx.x; w < total; w += gridDim.x)
        produce_chain<BF16>(d, smem, ws + (size_t)(w / num_tiles) * d.w_member * TC<BF16>::ESIZE,
                            it);
    }
    return;
  }
  unsigned char* a_buf = smem + TC_BARRIER_BYTES;
  const float* head = reinterpret_cast<const float*>(a_buf);
  const int din = d.dims[0], k0 = d.kp[0];
  const int dh = d.dims[d.num_products];
  uint32_t it = 0;
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    TC_STAMP(29)
    const int e = w / num_tiles;
    const int row0 = (w - e * num_tiles) * TC_ROWS;
    const int rows = min(TC_ROWS, S - row0);
    // the input tile as the first product's A operand, zero past the ragged
    // last tile's rows and past `in`
    const float* xe = x + ((size_t)e * S + row0) * din;
    for (int idx = threadIdx.x; idx < TC_ROWS * k0; idx += TC_CONSUMERS) {
      const int r = idx / k0, c = idx - r * k0;
      store_a<BF16>(a_buf, d.a_copy_bytes, r, c,
                    r < rows && c < din ? __ldg(xe + (size_t)r * din + c) : 0.0f);
    }
    fence_proxy_async();
    consumer_sync();
    TC_STAMP(2)
    consume_chain<ACT, BF16>(d, smem, bs + (size_t)e * d.b_member, it);
    float* o = out + ((size_t)e * S + row0) * dh;
    for (int idx = threadIdx.x; idx < rows * dh; idx += TC_CONSUMERS) {
      const int r = idx / dh, c = idx - r * dh;
      o[idx] = head_at(d, head, r, c);
    }
    consumer_sync();  // the head has been read: the next input may overwrite it
    TC_STAMP(30)
  }
}

// ---------------------------------------------------------------------------
// Two tiles a block

// Bytes of one warpgroup's copy of a member's biases (after the ring)
__host__ __device__ __forceinline__ int pair_bias_bytes(const ChainDesc& d) {
  return (d.b_member * 4 + 15) / 16 * 16;
}

// The ring's side of one product for a warpgroup: where it is in the ring.
struct PairRing {
  uint32_t it;     // ring buffers taken over the launch (both warpgroups count all)
  int s, prev;     // the current buffer, the previous one (freed once its products are done)
};

// Chunk c of product i: wait for its ring buffer if it is the buffer's
// first, issue its k-steps one commit group each, and once they are issued
// free the previous buffer (its products are done by then). PAIR_IN_FLIGHT
// k-steps are in flight, on as many fragment sets (a chunk has an even number
// of k-steps but its product's last: each set is written again only after its
// group is done).
template <bool BF16>
__device__ __forceinline__ void pair_take(const ChainDesc& d, uint32_t bars, int i, int c, int per,
                                          float* acc, uint32_t* f0, uint32_t* f1,
                                          const unsigned char* a, int warp, int lane,
                                          PairRing& ring) {
  using C = TC<BF16>;
  const int kp = d.kp[i], np = d.np[i];
  const int j = c % per;  // its place in the ring buffer
  if (j == 0) {
    ring.s = ring.it % d.stages;
    mbar_wait(bars + 8 * ring.s, (ring.it / d.stages) & 1);
  }
  const int k0 = c * C::CHUNK, steps = min(C::CHUNK, kp - k0) / C::KSTEP;
  const uint32_t b_lbo = np * 16;
  const uint32_t st = bars + TC_BARRIER_BYTES + d.a_bytes + ring.s * d.stage_bytes +
                      j * C::CHUNK * np * C::ESIZE * C::COPIES;
  const uint32_t lo = steps * C::KSTEP * np * C::ESIZE;  // the lo block follows the hi block
  for (int q = 0; q < steps; q += 2) {
    const uint32_t b = st + q * 2 * b_lbo;
    pair_step<BF16>(np / 8, c == 0 && q == 0, acc, f0, a, k0 / C::KSTEP + q, warp, lane, b, b + lo,
                    b_lbo);
    wgmma_wait<PAIR_IN_FLIGHT - 1>();
    if (q + 1 < steps) {
      pair_step<BF16>(np / 8, 0, acc, PAIR_IN_FLIGHT > 1 ? f1 : f0, a, k0 / C::KSTEP + q + 1, warp,
                      lane, b + 2 * b_lbo, b + 2 * b_lbo + lo, b_lbo);
      wgmma_wait<PAIR_IN_FLIGHT - 1>();
    }
  }
  if (j == 0) {
    mbar_arrive(bars + 64 + 8 * max(ring.prev, 0), lane == 0 && ring.prev >= 0);
    ring.prev = ring.s;
    ++ring.it;
  }
}

// Product i of this warpgroup's tile, A from its region `a`, into acc.
template <bool BF16>
__device__ __forceinline__ void pair_product(const ChainDesc& d, uint32_t bars, int i, float* acc,
                                             const unsigned char* a, int warp, int lane,
                                             PairRing& ring) {
  using C = TC<BF16>;
  const int per = ring_chunks<BF16>(d, i);
  const int nch = (d.kp[i] + C::CHUNK - 1) / C::CHUNK;
  uint32_t f0[8], f1[8];
  ring.prev = -1;
  for (int c = 0; c < nch; ++c) pair_take<BF16>(d, bars, i, c, per, acc, f0, f1, a, warp, lane, ring);
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 2 * ACC_REGS; ++j) asm volatile("" : "+f"(acc[j])::"memory");
  mbar_arrive(bars + 64 + 8 * ring.prev, lane == 0);
}

// A warpgroup with no tile in this pair (a member's odd last tile): take and
// free every ring buffer of the member's chain, as the other warpgroup does.
template <bool BF16>
__device__ __forceinline__ void pair_skip(const ChainDesc& d, uint32_t bars, int lane, PairRing& ring) {
  for (int i = 0; i < d.num_products; ++i) {
    const int run = ring_chunks<BF16>(d, i) * TC<BF16>::CHUNK;
    for (int k0 = 0; k0 < d.kp[i]; k0 += run) {
      const int s = ring.it % d.stages;
      mbar_wait(bars + 8 * s, (ring.it / d.stages) & 1);
      mbar_arrive(bars + 64 + 8 * s, lane == 0);
      ++ring.it;
    }
  }
}

// What the two-tile route reads through and finishes (mbrl_ensemble_mlp_head);
// all zero for the raw head (mbrl_ensemble_mlp).
struct PairHead {
  const long long* perm;  // slot e * S + p reads, and writes, batch row perm[e * S + p]; null: the slot
  const float* max_lv;    // (out) the log-variance's soft bounds
  const float* min_lv;
  const float* noise;     // (B, out) N(0, 1) in batch order, or null
  float* lv_out;          // (B, out): the bounded log-variance when noise is null
  int out;                // the head's out columns; 0: the raw head, (E, S, head_out) by slot
  unsigned div;           // ceil(2^20 / out): i / out = (i * div) >> 20 for every i < 16 * out
};

// Float i of the row-major staging of a warp's 16 rows of the head: the
// warp's own 512 bytes of each k-step of its warpgroup's A region
// (pair_slot), which no other warp reads or writes.
__device__ __forceinline__ float* pair_staged(unsigned char* a, int warp, int i) {
  return reinterpret_cast<float*>(a + ((i >> 7) * 4 + warp) * (PAIR_SLOT_BYTES / 4)) + (i & 127);
}

// The Gaussian head of this warp's 16 rows, finished in the last product's
// epilogue. The raw head (accumulators plus bias) is staged, 8 x n8 columns
// a row, in the warp's slots of the A region, free once the last product is
// done (the warp's rows are its wgmma rows); then read a column a lane, row
// by row, so that the noise is read and each row written at its place in
// the batch with coalesced accesses: lane l holds the batch row of the
// warp's row l, two elements a lane a pass, their noise loaded before either
// is computed. No branch depends on the lane (a lane past the last element
// repeats it, writing the same value to the same place), and `warp` comes
// through a shuffle: a path ptxas takes for divergent in the loop around the
// products made it serialize every wgmma of the kernel (C7520).
// PyTorch's arithmetic op for op, in f32 (GaussianMLP's _bound:
// kernels.bound_logvar, logaddexp's CUDA formula; sample_1d's draw), each of
// its roundings its own (__fmul_rn, __fadd_rn: nothing contracted into an
// FMA that PyTorch does not make).
__device__ __forceinline__ void pair_gaussian_head(const float* acc, const float* bias, int n8,
                                                   int dh, const PairHead& hd, unsigned char* a,
                                                   int warp, int lane, size_t slot0, int rows,
                                                   float* out) {
  const int g = lane >> 2, c0 = 2 * (lane & 3), ns = 8 * n8;
#pragma unroll
  for (int j = 0; j < ACC_REGS / 2; ++j) {
    if (j < n8) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rr = g + 8 * (u >> 1), cc = c0 + 8 * j + (u & 1);
        *pair_staged(a, warp, rr * ns + cc) = acc[4 * j + u] + (cc < dh ? bias[cc] : 0.0f);
      }
    }
  }
  __syncwarp();
  const int o = hd.out, r0 = 16 * warp, nr = min(16, rows - r0);
  if (nr > 0) {
    const size_t slot = slot0 + r0 + min(lane, nr - 1);
    const long long mine = hd.perm ? __ldg(hd.perm + slot) : (long long)slot;
    const int n = nr * o;
    for (int base = 0; base < n; base += 64) {
      int i[2], c[2];
      long long at[2];
      float z[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const unsigned idx = min(base + 32 * k + lane, n - 1);
        const int rr = (idx * hd.div) >> 20;
        c[k] = idx - rr * o;
        i[k] = rr * ns + c[k];
        at[k] = __shfl_sync(0xffffffffu, mine, rr) * o + c[k];
        z[k] = hd.noise ? __ldg(hd.noise + at[k]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float mean = *pair_staged(a, warp, i[k]);
        const float lv = bound_logvar(*pair_staged(a, warp, i[k] + o), __ldg(hd.max_lv + c[k]),
                                      __ldg(hd.min_lv + c[k]));
        if (hd.noise) {
          out[at[k]] = __fadd_rn(mean, __fmul_rn(expf(__fmul_rn(0.5f, lv)), z[k]));
        } else {
          out[at[k]] = mean;
          hd.lv_out[at[k]] = lv;
        }
      }
    }
  }
  __syncwarp();  // every lane has read the staging before the next tile's A goes there
}

// grid = (blocks,), TC_CHAIN_THREADS threads: pairs (member, tiles 2p and 2p
// + 1) of the member-major list, block b taking b, b + blocks, ...;
// `member_pairs` = ceil(num_tiles / 2), `total` = E * member_pairs. Compiled
// per dtype only, the activation (`act`) a switch around the epilogue: the
// products, compiled for every width and chunk depth, are the bulk of the
// code, and six copies of them took minutes of ptxas.
template <bool BF16>
__global__ void __launch_bounds__(TC_CHAIN_THREADS, 1)
ensemble_mlp_pair_kernel(const float* __restrict__ x, const unsigned char* __restrict__ ws,
                         const float* __restrict__ bs, float* __restrict__ out, const ChainDesc d,
                         int S, int num_tiles, int member_pairs, int total, int act,
                         const PairHead hd) {
  extern __shared__ __align__(128) unsigned char smem[];
  TC_STAMP(0)
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(smem);
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                       // full: the producer's expect_tx
      mbar_init(bars + 64 + 8 * s, TC_CONSUMERS / 32);  // empty: one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  TC_STAMP(1)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 2) {  // the producer warpgroup: its first thread streams each pair's member once
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0;
      for (int p = blockIdx.x; p < total; p += gridDim.x)
        produce_chain<BF16>(d, smem, ws + (size_t)(p / member_pairs) * d.w_member * TC<BF16>::ESIZE,
                            it);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const uint32_t bars = smem_u32(smem);
    // the warp index through a shuffle: ptxas then sees the head's loop
    // bounds (rows past the warp's first) as warp-uniform; taken from
    // threadIdx, its divergent path serialized every wgmma (C7520)
    const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0), lane = threadIdx.x & 31;
    const int din = d.dims[0], dh = d.dims[d.num_products];
    unsigned char* a = smem + TC_BARRIER_BYTES + wg * d.a_copy_bytes;
    float* bias = reinterpret_cast<float*>(smem + d.extra_off + wg * pair_bias_bytes(d));
    PairRing ring{0, 0, -1};
    for (int p = blockIdx.x; p < total; p += gridDim.x) {
      const int e = p / member_pairs;
      const int tile = 2 * (p - e * member_pairs) + wg;
      if (tile >= num_tiles) {
        pair_skip<BF16>(d, bars, lane, ring);
        continue;
      }
      TC_STAMP(29)
      const int row0 = tile * TC_ROWS, rows = min(TC_ROWS, S - row0);
      const int r = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
      // the input tile as the first product's A, zero past the ragged last
      // tile's rows and past `in`: rows r and r + 8 of this thread's lanes,
      // each the batch row its slot reads (through perm, once a tile)
      const size_t slot0 = (size_t)e * S + row0;
      const float* xr[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const size_t slot = slot0 + r + 8 * u;
        const long long row =
            r + 8 * u >= rows ? 0 : hd.perm ? __ldg(hd.perm + slot) : (long long)slot;
        xr[u] = x + (size_t)row * din;
      }
      // the member's biases into this warpgroup's copy, once its last tile
      // has read them
      asm volatile("bar.sync %0, %1;" ::"r"(PAIR_WG_BARRIER + wg), "n"(128) : "memory");
      for (int idx = threadIdx.x & 127; idx < d.b_member; idx += 128)
        bias[idx] = __ldg(bs + (size_t)e * d.b_member + idx);
      for (int q = 0; q < d.kp[0] / TC<BF16>::KSTEP; ++q) {
        float v[8];
#pragma unroll
        for (int h = 0; h < (BF16 ? 2 : 1); ++h) {
          const int c = (BF16 ? 16 * q : 8 * q) + 8 * h + c0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {  // (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1)
            const int rr = r + 8 * (u >> 1), cc = c + (u & 1);
            v[4 * h + u] = rr < rows && cc < din ? __ldg(xr[u >> 1] + cc) : 0.0f;
          }
        }
        pair_store<BF16>(a, q, warp, lane, v);
      }
      asm volatile("bar.sync %0, %1;" ::"r"(PAIR_WG_BARRIER + wg), "n"(128) : "memory");
      TC_STAMP(2)
      for (int i = 0; i < d.num_products; ++i) {
        float acc[2 * ACC_REGS];
        pair_product<BF16>(d, bars, i, acc, a, warp, lane, ring);
        TC_STAMP(3 + 3 * i)
        __syncwarp();  // every lane has read its fragments of this product
        const int n8 = d.np[i] / 8, dout = d.dims[i + 1];
        if (i + 1 < d.num_products) {
          pair_epilogue<BF16>(act, acc, bias + d.b_off[i], n8, dout, a, warp, lane);
          __syncwarp();
        } else if (hd.out) {
          pair_gaussian_head(acc, bias + d.b_off[i], n8, dh, hd, a, warp, lane, slot0, rows, out);
        } else {  // the raw head, straight out: rows r and r + 8, columns c and c + 1
          float* o = out + slot0 * dh;
          const float* b = bias + d.b_off[i];
#pragma unroll
          for (int j = 0; j < ACC_REGS / 2; ++j) {
            const int c = c0 + 8 * j;
            if (j < n8) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int rr = r + 8 * (u >> 1), cc = c + (u & 1);
                if (rr < rows && cc < dh) o[(size_t)rr * dh + cc] = acc[4 * j + u] + b[cc];
              }
            }
          }
        }
        TC_STAMP(5 + 3 * i)
      }
      TC_STAMP(30)
    }
  }
}

// ---------------------------------------------------------------------------
// A cluster a member

// The stack's plain layout (pack_mlp): product i's (K, N) row-major at w_off[i]
struct PlainDesc {
  int num_products;
  int dims[MAX_PRODUCTS + 1];
  int w_off[MAX_PRODUCTS];
  int b_off[MAX_PRODUCTS];
  int w_member, b_member;
  int kmax;     // the widest product input: a row of the activation buffers
  int cluster;  // blocks of a member's cluster
};

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" ::
                   : "memory");
}

// v into `p` of every block of the cluster (p: this block's shared address)
__device__ __forceinline__ void cluster_store(float* p, float v, int blocks) {
  const uint32_t local = smem_u32(p);
  for (int b = 0; b < blocks; ++b) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(b));
    asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// This warp's k-slice of product i's column c, [k0, k1), into registers
template <typename W, typename V>
__device__ __forceinline__ void cluster_weights(V* wk, const W* w, int N, int k0, int k1, int c,
                                                bool valid) {
#pragma unroll
  for (int u = 0; u < CLUSTER_KSLICE; ++u)
    wk[u] = valid && k0 + u < k1 ? static_cast<V>(w[(size_t)(k0 + u) * N + c]) : static_cast<V>(0.0f);
}

// grid = (E * C,), clusters of C = pd.cluster blocks, CLUSTER_THREADS
// threads, S <= TC_ROWS rows a member. Shared memory: two activation buffers
// (S, kmax) f32, the next product's input written by every block, then the
// k-slices' partial sums. Warp w takes a contiguous slice of every product's
// K (4-aligned, at most CLUSTER_KSLICE rows) for 32 columns, lane l column
// l, over rows in passes of CLUSTER_PASS_ROWS; the next product's weights are
// loaded into registers while this one runs. bf16 stacks round the input
// and every hidden activation to bf16, where the TPU kernel rounds them.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
ensemble_mlp_cluster_kernel(const float* __restrict__ x, const void* __restrict__ ws_,
                            const float* __restrict__ bs, float* __restrict__ out, const PlainDesc pd,
                            int S) {
  using W = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  extern __shared__ __align__(16) float act_s[];
  TC_STAMP(0)
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int C = pd.cluster, e = blockIdx.x / C, ks = pd.kmax;
  float* red = act_s + 2 * S * ks;  // [8 warps][CLUSTER_PASS_ROWS][32 columns]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int din = pd.dims[0], dh = pd.dims[pd.num_products];
  const W* wm = static_cast<const W*>(ws_) + (size_t)e * pd.w_member;
  const float* bm = bs + (size_t)e * pd.b_member;
  // product i's share of columns [n0, n1) and this warp's k-slice [k0, k1)
  auto share = [&](int i, int& n0, int& n1, int& k0, int& k1) {
    const int N = pd.dims[i + 1], K = pd.dims[i], per = (N + C - 1) / C;
    const int slice = ((K + 7) / 8 + 3) / 4 * 4;
    n0 = rank * per, n1 = min(N, n0 + per), k0 = min(K, warp * slice), k1 = min(K, k0 + slice);
  };
  float wk[CLUSTER_KSLICE], bk, bn = 0.0f;  // this product's weights and bias of column l
  W wn[CLUSTER_KSLICE];  // the next product's, converted when they are used
  {
    int n0, n1, k0, k1;
    share(0, n0, n1, k0, k1);
    cluster_weights(wk, wm, pd.dims[1], k0, k1, n0 + lane, n0 + lane < n1);
    bk = n0 + lane < n1 ? __ldg(bm + n0 + lane) : 0.0f;
  }
  for (int idx = threadIdx.x; idx < 2 * S * ks; idx += CLUSTER_THREADS) {  // zero past each K
    const int r = idx / ks % S, c = idx % ks;
    act_s[idx] = idx < S * ks && c < din ? operand<BF16>(__ldg(x + ((size_t)e * S + r) * din + c))
                                         : 0.0f;
  }
  cluster_sync_all();  // the input staged, and every block of the cluster running
  TC_STAMP(2)
  for (int i = 0; i < pd.num_products; ++i) {
    const int N = pd.dims[i + 1];
    const bool head = i + 1 == pd.num_products;
    int n0, n1, k0, k1;
    share(i, n0, n1, k0, k1);
    if (!head) {  // the next product's first 32 columns, while this one runs
      int m0, m1, j0, j1;
      share(i + 1, m0, m1, j0, j1);
      cluster_weights(wn, wm + pd.w_off[i + 1], pd.dims[i + 2], j0, j1, m0 + lane, m0 + lane < m1);
      bn = m0 + lane < m1 ? __ldg(bm + pd.b_off[i + 1] + m0 + lane) : 0.0f;
    }
    const float* in = act_s + (i & 1) * S * ks;
    float* nxt = act_s + ((i + 1) & 1) * S * ks;
    for (int cb = n0; cb < n1; cb += 32) {
      const int c = cb + lane;
      if (cb != n0) {
        cluster_weights(wk, wm + pd.w_off[i], N, k0, k1, c, c < n1);
        bk = c < n1 ? __ldg(bm + pd.b_off[i] + c) : 0.0f;
      }
      for (int r0 = 0; r0 < S; r0 += CLUSTER_PASS_ROWS) {
        float acc[CLUSTER_PASS_ROWS] = {};
#pragma unroll
        for (int u = 0; u < CLUSTER_KSLICE; u += 4) {
          if (k0 + u < k1) {
#pragma unroll
            for (int rr = 0; rr < CLUSTER_PASS_ROWS; ++rr) {
              if (r0 + rr < S) {
                const float4 a = *reinterpret_cast<const float4*>(in + (r0 + rr) * ks + k0 + u);
                acc[rr] = fmaf(a.x, wk[u], fmaf(a.y, wk[u + 1], fmaf(a.z, wk[u + 2],
                          fmaf(a.w, wk[u + 3], acc[rr]))));
              }
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < CLUSTER_PASS_ROWS; ++rr) red[(warp * CLUSTER_PASS_ROWS + rr) * 32 + lane] = acc[rr];
        __syncthreads();
        // thread (rr, lane): row r0 + rr, column cb + lane, summed over the 8 k-slices
        const int rr = warp, r = r0 + rr;
        if (r < S && c < n1) {
          float v = bk;
#pragma unroll
          for (int s = 0; s < 8; ++s) v += red[(s * CLUSTER_PASS_ROWS + rr) * 32 + lane];
          if (head)
            out[((size_t)e * S + r) * dh + c] = v;
          else
            cluster_store(nxt + r * ks + c, operand<BF16>(tc_activate<ACT>(v)), C);
        }
        __syncthreads();
      }
    }
    TC_STAMP(3 + 3 * i)
    if (!head) cluster_sync_all();  // every block's columns of this product are in place
    TC_STAMP(5 + 3 * i)
#pragma unroll
    for (int u = 0; u < CLUSTER_KSLICE; ++u) wk[u] = to_float(wn[u]);
    bk = bn;
  }
  TC_STAMP(30)
}

// ---------------------------------------------------------------------------
// Host side

// The two-tile route's plan: the chain's layout (make_chain_desc, so that the
// two routes take the same stacks), A as two warpgroups' regions of one copy
// (pair_slot), a ring of up to PAIR_MAX_STAGES buffers after them, then each
// warpgroup's copy of its member's biases (at extra_off).
template <bool BF16>
static bool make_pair_desc(const int* dims, int num_products, ChainDesc* d, size_t* smem) {
  using C = TC<BF16>;
  if (!make_chain_desc<BF16>(dims, num_products, 0, d, smem)) return false;
  int kmax = 0;
  for (int i = 0; i < num_products; ++i) kmax = kmax > d->kp[i] ? kmax : d->kp[i];
  d->a_copy_bytes = kmax / C::KSTEP * PAIR_SLOT_BYTES;
  d->a_bytes = 2 * d->a_copy_bytes;
  const int biases = 2 * pair_bias_bytes(*d);
  const int stages = (TC_SMEM_LIMIT - TC_BARRIER_BYTES - d->a_bytes - biases) / d->stage_bytes;
  d->stages = stages < PAIR_MAX_STAGES ? stages : PAIR_MAX_STAGES;
  if (d->stages < 2) return false;
  d->extra_off = TC_BARRIER_BYTES + d->a_bytes + d->stages * d->stage_bytes;
  *smem = d->extra_off + biases;
  return true;
}

static bool make_plain_desc(const int* dims, int num_products, int cluster, PlainDesc* pd,
                            size_t* smem, int rows) {
  if (num_products < 1 || num_products > MAX_PRODUCTS || cluster < 2 || cluster > CLUSTER_MAX ||
      rows > TC_ROWS)
    return false;
  pd->num_products = num_products;
  pd->cluster = cluster;
  int w = 0, b = 0, kmax = 4;
  for (int i = 0; i <= num_products; ++i) {
    if (dims[i] < 1 || dims[i] > TC_MAX_WIDTH) return false;
    pd->dims[i] = dims[i];
  }
  for (int i = 0; i < num_products; ++i) {
    pd->w_off[i] = w;
    pd->b_off[i] = b;
    w += dims[i] * dims[i + 1];
    b += dims[i + 1];
    kmax = kmax > dims[i] ? kmax : dims[i];
  }
  pd->w_member = w;
  pd->b_member = b;
  pd->kmax = (kmax + 3) / 4 * 4;  // a row of the activation buffers, 16-byte aligned
  *smem = sizeof(float) * (2 * (size_t)rows * pd->kmax + 8 * CLUSTER_PASS_ROWS * 32);
  return true;
}

#define LAUNCH_K3(ACT, BF16, grid, smem, stream, ...)                                          \
  {                                                                                            \
    cudaError_t err = prepare_once<ensemble_mlp_tc_kernel<ACT, BF16>>();                       \
    if (err != cudaSuccess) return err;                                                        \
    ensemble_mlp_tc_kernel<ACT, BF16><<<grid, TC_CHAIN_THREADS, smem, stream>>>(__VA_ARGS__);  \
  }

#define LAUNCH_K3_PAIR(BF16, grid, smem, stream, ...)                                    \
  {                                                                                      \
    cudaError_t err = prepare_once<ensemble_mlp_pair_kernel<BF16>>();                    \
    if (err != cudaSuccess) return err;                                                  \
    ensemble_mlp_pair_kernel<BF16><<<grid, TC_CHAIN_THREADS, smem, stream>>>(__VA_ARGS__);  \
  }

// The two-tile route's launch (K3_PAIR): its plan, its grid's checks, the
// kernel; `hd` all zero for the raw head.
static cudaError_t launch_pair(int bf16, const int* dims, int num_products, int num_members,
                               int rows, int blocks, int act, const float* x,
                               const unsigned char* wt, const float* bs, float* out,
                               const PairHead& hd, cudaStream_t s) {
  ChainDesc d;
  size_t smem;
  const bool ok = bf16 ? make_pair_desc<true>(dims, num_products, &d, &smem)
                       : make_pair_desc<false>(dims, num_products, &d, &smem);
  const int num_tiles = (rows + TC_ROWS - 1) / TC_ROWS;
  const int member_pairs = (num_tiles + 1) / 2;
  const long long total = (long long)member_pairs * num_members;
  if (!ok || blocks < 1 || blocks > total || total > INT_MAX) return cudaErrorInvalidValue;
  if (act < ACT_RELU || act > ACT_LEAKY_RELU) return cudaErrorInvalidValue;
  // a Gaussian head of 2 x out columns, staged as (64, padded head) f32 in
  // one warpgroup's A region (pair_gaussian_head)
  if (hd.out && (2 * hd.out != dims[num_products] ||
                 TC_ROWS * 4 * d.np[num_products - 1] > d.a_copy_bytes))
    return cudaErrorInvalidValue;
  const dim3 grid(blocks);
  if (bf16) {
    LAUNCH_K3_PAIR(true, grid, smem, s, x, wt, bs, out, d, rows, num_tiles, member_pairs,
                   (int)total, act, hd)
  } else {
    LAUNCH_K3_PAIR(false, grid, smem, s, x, wt, bs, out, d, rows, num_tiles, member_pairs,
                   (int)total, act, hd)
  }
  return cudaSuccess;
}

#define LAUNCH_K3_CLUSTER(ACT, BF16, cfg, ...)                                                \
  {                                                                                           \
    cudaError_t err = prepare_once<ensemble_mlp_cluster_kernel<ACT, BF16>>();                 \
    if (err != cudaSuccess) return err;                                                       \
    err = cudaLaunchKernelEx(&cfg, ensemble_mlp_cluster_kernel<ACT, BF16>, __VA_ARGS__);      \
    if (err != cudaSuccess) return err;                                                       \
  }

extern "C" {

// `tiles` is pack_chain()'s weight tensor; `tile_elems` its elements per
// member, checked against this side's layout; `ws` the stack's plain weights
// (pack_mlp; the cluster route reads them). `route` is K3_TILE, K3_PAIR or
// K3_CLUSTER and `blocks` its grid (k3_route and k3_blocks in ops/kernels.py).
int mbrl_ensemble_mlp(const float* x, const void* tiles, const float* bs, float* out,
                      const int* dims, int num_products, int num_members, int rows, int blocks,
                      int act, int bf16, long long tile_elems, const void* ws, int route,
                      void* stream) {
  ChainDesc d;
  size_t smem;
  if (!make_chain_desc(bf16, dims, num_products, 0, &d, &smem) || rows < 1 ||
      num_members < 1 || d.w_member != tile_elems)
    return cudaErrorInvalidValue;
  const int num_tiles = (rows + TC_ROWS - 1) / TC_ROWS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* wt = static_cast<const unsigned char*>(tiles);
  if (route == K3_TILE) {
    const long long total = (long long)num_tiles * num_members;
    if (blocks < 1 || blocks > total || total > INT_MAX) return cudaErrorInvalidValue;
    const dim3 grid(blocks);
    DISPATCH(act, bf16, LAUNCH_K3, grid, smem, s, x, wt, bs, out, d, rows, num_tiles, (int)total)
  } else if (route == K3_PAIR) {
    const cudaError_t err = launch_pair(bf16, dims, num_products, num_members, rows, blocks, act,
                                        x, wt, bs, out, PairHead{}, s);
    if (err != cudaSuccess) return err;
  } else if (route == K3_CLUSTER) {
    PlainDesc pd;
    if (blocks % num_members != 0 ||
        !make_plain_desc(dims, num_products, blocks / num_members, &pd, &smem, rows))
      return cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pd.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(CLUSTER_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    DISPATCH(act, bf16, LAUNCH_K3_CLUSTER, cfg, x, ws, bs, out, pd, rows)
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K3's two-tile route with the Gaussian head finished in its epilogue, in the
// batch's order: x is the (B = num_members x rows, in) batch, slot p of
// member e reads batch row perm[e * rows + p] and its results go to that row.
// With `noise` (B, out): out = mean + exp(logvar / 2) * noise; without, out
// the mean and lv_out the bounded log-variance; each (B, out). Grid, tiles and
// checks as mbrl_ensemble_mlp's K3_PAIR (kernels.k3_fuses_head picks it).
int mbrl_ensemble_mlp_head(const float* x, const void* tiles, const float* bs,
                           const long long* perm, const float* max_lv, const float* min_lv,
                           const float* noise, float* out, float* lv_out, const int* dims,
                           int num_products, int num_members, int rows, int blocks, int act,
                           int bf16, long long tile_elems, int out_size, void* stream) {
  ChainDesc d;
  size_t smem;
  if (!make_chain_desc(bf16, dims, num_products, 0, &d, &smem) || rows < 1 ||
      num_members < 1 || d.w_member != tile_elems || out_size < 1 || !perm || !max_lv ||
      !min_lv || !(noise || lv_out))
    return cudaErrorInvalidValue;
  const PairHead hd{perm, max_lv, min_lv, noise, lv_out, out_size,
                    ((1u << 20) + out_size - 1) / out_size};
  const cudaError_t err =
      launch_pair(bf16, dims, num_products, num_members, rows, blocks, act, x,
                  static_cast<const unsigned char*>(tiles), bs, out, hd,
                  static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
