// The SAC policy's forward on Hopper (sm_90a), written by hand:
// policy_linear1_kernel, policy_mlp_kernel<NH> and policy_heads_kernel,
// launched in that order by the entry mbrl_policy_mlp.
//
// Replaces no Pallas kernel: the JAX package's SAC policy
// (mbrl_tpu/planning/sac.py, GaussianPolicy) is plain jnp that XLA compiles.
// It was added because in MBPO's imagined rollout the policy, not the model,
// sets the pace: every step runs the 1,024-wide policy on all 100,000 rows,
// and cuBLAS runs its f32 products as FFMA on the CUDA cores, 76% of their
// 67 TFLOP/s peak already, with two ReLU passes and two narrow head products
// over the 410 MB hidden layer beside them (PERF.md).
//
// What it computes (ops/kernels.py: fused_policy_mlp, and its plain version
// fused_policy_mlp_plain, which repeats this arithmetic): for x (rows, in),
//   h1 = relu(x W1^T + b1)                 3xTF32 on the tensor cores
//   h2 = relu(h1 W2^T + b2)                3xTF32
//   [mean | log_std] = h2 [Wm | Ws]^T + b  3xTF32, the sum over h2's column
//                                          tiles in a fixed order, then the
//                                          biases and log_std's clamp
// 3xTF32 keeps f32-grade products: each operand is split into a tf32 hi
// (rounded to nearest, ties away) and the tf32 of the rest, lo, and a
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in f32 (the split
// of K3's f32 routes; pack_policy splits the weights once).
//
// What bounds it: operations. At 100,000 rows and 1,024 columns linear2 is
// 2.1e11 FLOP a call, 1.27 ms at the 495 / 3 TFLOP/s of f32-grade products;
// h1 (410 MB in f32) is written once and read from L2.
//
// Design.
// - linear1 (policy_linear1_kernel): a warpgroup a block computes 256 rows x
//   128 columns of h1 on wgmma (K is the observation, 17-45, padded to 8)
//   and writes h1 once, in the order the main kernel's A fragments are read:
//   per 256-row block and 16-column chunk, 16 KB contiguous, as
//   [64-row subtile][k-step][warp][lane][4 floats] (a tf32 m64k8 A fragment:
//   (r, t), (r + 8, t), (r, t + 4), (r + 8, t + 4) for r = 16 warp + lane / 4,
//   t = lane % 4). Rows past the call's are computed from zero inputs.
// - linear2 and the heads (policy_mlp_kernel): persistent clusters of two
//   blocks, one block an SM, walk the tiles of 256 rows x 128 columns of h2,
//   column tile fastest, so that a row block's column tiles run at once on
//   neighbouring clusters and read its h1 from L2. Each block takes 128 rows
//   of a tile; a block is TC_CHAIN_THREADS threads: a producer warpgroup
//   whose first thread keeps a ring of PM_STAGES buffers in flight with bulk
//   async copies (its rows of h1's chunk, 8 KB, and half of W2's hi/lo chunk,
//   8 KB, multicast into both blocks, so each weight chunk fetched serves 256
//   rows), and two consumer warpgroups (setmaxnreg 232; the producer 40),
//   each 64 rows at the full 128 columns, one wgmma of each of the three
//   products a k-step. A comes from registers: each k-step's fragment is one
//   16-byte shared-memory load, split into hi and lo there (wgmma_rs.cuh), so
//   h1 needs no hi/lo copies. One commit group a k-step, two in flight: ptxas
//   serializes register-A wgmma otherwise. A ring buffer is free once every
//   consumer warp of both blocks has released it.
// - wgmma's f32 sums round toward zero, once an instruction: 384 of them into
//   one accumulator over 1,024 K rows left h2 1e-5 off (the outputs 4e-6, on
//   an H100; an f32 FMA chain is 2e-7 off). So every PM_FLUSH k-steps the
//   accumulators are drained into f32 sums held beside them (round to
//   nearest), and the next k-step starts them afresh; the heads' product
//   flushes halfway too. That keeps the outputs within 5e-7 of the float64
//   forward (emulated) for 64 more registers a thread, which two tiles of 64
//   rows a warpgroup would not leave: hence 128 rows a block, in clusters.
// - The epilogue keeps h2 in registers: bias, ReLU, and the split of each
//   8-column group of the accumulators straight into an A fragment of the
//   heads' product. A wgmma accumulator holds (r, 2t), (r, 2t + 1), (r + 8,
//   2t), (r + 8, 2t + 1) of a group, so the fragment's k-step takes columns
//   0, 2, 4, 6, 1, 3, 5, 7 of it; pack_policy orders the heads' rows the
//   same way. The heads [Wm | Ws] of the tile's 128 columns come through
//   the ring as two more buffers; the tile's partial heads (NH padded
//   columns, a template parameter: 16, 32, 48 or 64) go to a partial array,
//   one slice a column tile. h2 never reaches device memory.
// - policy_heads_kernel sums the slices in column-tile order (no atomics,
//   the same result every call), adds the heads' biases and clamps log_std.
// - Every loop bound around a wgmma is block-uniform, and both blocks of a
//   cluster walk the same tiles; a cluster barrier at the start and the end
//   keeps either block from copying into, or leaving, the other too early.
//
// Plain C interface, loaded with ctypes; the entry returns cudaGetLastError()
// after its launches.

#include <limits.h>

#include "tc_chain.cuh"
#include "wgmma_rs.cuh"
#include "wide_tc.cuh"

#define PM_ROWS 256                        // rows of a cluster's tile: h1's row block
#define PM_CLUSTER 2                       // blocks of a cluster, 128 rows each
#define PM_BLOCK_ROWS (PM_ROWS / PM_CLUSTER)
#define PM_COLS 128                        // columns of h2 a tile
#define PM_KC 16                           // K rows of a ring chunk: two tf32 k-steps
#define PM_FLUSH 8                         // k-steps between flushes of wgmma's sums
#define PM_STAGES 6
#define PM_A_BYTES (PM_BLOCK_ROWS * PM_KC * 4)  // a block's h1 chunk: 8 KB
#define PM_B_BYTES (PM_KC * PM_COLS * 4 * 2)    // W2's chunk, hi then lo: 16 KB
#define PM_STAGE_BYTES 32768               // a chunk (24 KB) or a head buffer (up to 32 KB)
#define PM_BAR_BYTES 128                   // full[s] at 8s, empty[s] at 64 + 8s
#define PM_FRAG_BYTES 2048                 // one k-step of a 64-row A: 4 warps x 32 lanes x 16 B
#define PM_B_LBO (PM_COLS * 16)            // W2's chunk: bytes between k-adjacent core matrices
#define PM_HEAD_MAX 64                     // padded head columns at most
#define PM_MAX_HIDDEN 2048                 // h2's biases in shared memory
#define PM_MAX_IN 64                       // linear1's K: its fragments in registers
#define PM_L1_THREADS 128

// Pins N registers after a wait: no read of them moves above it.
template <int N>
__device__ __forceinline__ void pin(float* v) {
#pragma unroll
  for (int j = 0; j < N; ++j) asm volatile("" : "+f"(v[j])::"memory");
}

// ---------------------------------------------------------------------------
// linear1

// grid = (row blocks, hidden / PM_COLS), one warpgroup a block: its four
// 64-row subtiles of one row block, one after the other, at the block's 128
// columns, in 3xTF32 on wgmma with A (x) from registers and B (W1^T's
// columns, hi and lo, K padded to a multiple of 8) in shared memory, landed
// by one bulk copy. pack_policy orders the columns of each 8 so that the
// accumulators of a group, (r, 2t), (r, 2t + 1), (r + 8, 2t), (r + 8, 2t +
// 1), hold h1's (r, t), (r, t + 4), (r + 8, t), (r + 8, t + 4): each lane
// stores its own float4 of h1's fragment layout. A subtile's inputs are all
// loaded before its first product, so that their latencies overlap: loaded
// k-step by k-step, behind each product, they took 0.35 ms at Humanoid's 45
// inputs (on an H100, as long as the same work on the FMA units), where the
// 410 MB of h1 take 0.12 ms to write.
__global__ void __launch_bounds__(PM_L1_THREADS)
policy_linear1_kernel(const float* __restrict__ x, const unsigned char* __restrict__ w1,
                      const float* __restrict__ b1, float* __restrict__ h1, int rows, int din,
                      int hidden) {
  extern __shared__ __align__(128) unsigned char l1s[];
  const int kp = (din + 7) / 8 * 8, steps = kp / 8;
  const uint32_t lo = kp * PM_COLS * 4;  // the lo copy follows the hi copy
  const int m = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const uint32_t bar = smem_u32(l1s), b = bar + 128;
  if (tid == 0) {  // this column tile's W1 tiles (hi, lo) in one bulk copy
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, 2 * lo);
    bulk_load(b, w1 + (size_t)n * 2 * lo, 2 * lo, bar);
  }
  __syncthreads();  // the barrier is set up before any thread waits on it
  const int nc = hidden / PM_KC;
  const int r = 16 * warp + (lane >> 2);
  for (int sub = 0; sub < PM_ROWS / 64; ++sub) {
    const int row0 = m * PM_ROWS + 64 * sub;
    const float* x0 = x + (size_t)(row0 + r) * din;
    const float* x8 = x0 + (size_t)8 * din;
    const bool in0 = row0 + r < rows, in1 = row0 + r + 8 < rows;
    // k-step q's fragment: (r, c), (r + 8, c), (r, c + 4), (r + 8, c + 4), c = 8q + t
    float v[PM_MAX_IN / 8][4];
#pragma unroll
    for (int q = 0; q < PM_MAX_IN / 8; ++q) {
      const int c = 8 * q + t;
      v[q][0] = in0 && c < din ? __ldg(x0 + c) : 0.0f;
      v[q][1] = in1 && c < din ? __ldg(x8 + c) : 0.0f;
      v[q][2] = in0 && c + 4 < din ? __ldg(x0 + c + 4) : 0.0f;
      v[q][3] = in1 && c + 4 < din ? __ldg(x8 + c + 4) : 0.0f;
    }
    if (sub == 0) mbar_wait(bar, 0);
    float acc[ACC_REGS];
    uint32_t f0[8], f1[8];
#pragma unroll
    for (int q = 0; q < PM_MAX_IN / 8; ++q) {
      if (q < steps) {
        uint32_t* f = (q & 1) ? f1 : f0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float hi = to_tf32(v[q][k]);
          f[k] = __float_as_uint(hi);
          f[4 + k] = __float_as_uint(to_tf32(v[q][k] - hi));
        }
        const uint32_t bq = b + q * 2 * PM_B_LBO;
        pair_issue<PM_COLS, false>(q == 0, acc, f, bq, bq + lo, PM_B_LBO);
        wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();
    pin<ACC_REGS>(acc);
#pragma unroll
    for (int j = 0; j < PM_COLS / 8; ++j) {  // the biases of h1's columns 8j + t and 8j + t + 4
      const int kstep = n * PM_COLS / 8 + j;
      const float bt = __ldg(b1 + 8 * kstep + t), bt4 = __ldg(b1 + 8 * kstep + t + 4);
      float* dst = h1 + ((((size_t)m * nc + kstep / 2) * 4 + sub) * 2 + kstep % 2) * 512 +
                   warp * 128 + lane * 4;
      *reinterpret_cast<float4*>(dst) =
          make_float4(fmaxf(acc[4 * j] + bt, 0.0f), fmaxf(acc[4 * j + 2] + bt, 0.0f),
                      fmaxf(acc[4 * j + 1] + bt4, 0.0f), fmaxf(acc[4 * j + 3] + bt4, 0.0f));
    }
  }
}

// ---------------------------------------------------------------------------
// linear2 and the heads

// This thread's A fragment of one k-step of a 64-row subtile (h1's layout),
// split into tf32 hi (f[0..3]) and lo (f[4..7]).
__device__ __forceinline__ void policy_fragment(uint32_t* f, const unsigned char* a, int warp,
                                                int lane) {
  const float4 v = *reinterpret_cast<const float4*>(a + warp * 512 + lane * 16);
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float hi = to_tf32(x[k]);
    f[k] = __float_as_uint(hi);
    f[4 + k] = __float_as_uint(to_tf32(x[k] - hi));
  }
}

// Column group j of h2 (bias b0 at column 2t, b1 at 2t + 1, ReLU) as the
// heads' A fragment, split: k = t holds column 2t, k = t + 4 column 2t + 1.
__device__ __forceinline__ void head_fragment(uint32_t* f, const float* acc, float b0, float b1) {
  const float x[4] = {fmaxf(acc[0] + b0, 0.0f), fmaxf(acc[2] + b0, 0.0f),
                      fmaxf(acc[1] + b1, 0.0f), fmaxf(acc[3] + b1, 0.0f)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float hi = to_tf32(x[k]);
    f[k] = __float_as_uint(hi);
    f[4 + k] = __float_as_uint(to_tf32(x[k] - hi));
  }
}

// One warpgroup's heads: its 64 rows of h2 (the f32 sums, 64 a thread)
// through bias and ReLU into 16 k-steps of the heads' product on the two head
// buffers (h0: the tile's columns 0-63, h1b: 64-127), each buffer's 8 k-steps
// summed in f32 apart (a flush, as the products'), then its partial heads to
// `part` (rows r and r + 8, columns below `ho`).
template <int NH>
__device__ __forceinline__ void policy_heads(const float* acc, const float* b2, uint32_t h0,
                                             uint32_t h1b, float* part, int ho, int r, int lane) {
  constexpr uint32_t lbo = NH * 16, lo = 64 * NH * 4;
  const int t = lane & 3;
  float h[NH / 2], hs[NH / 2];
  uint32_t f0[8], f1[8];
#pragma unroll
  for (int j = 0; j < PM_COLS / 8; ++j) {
    uint32_t* f = (j & 1) ? f1 : f0;
    head_fragment(f, acc + 4 * j, b2[8 * j + 2 * t], b2[8 * j + 2 * t + 1]);
    const uint32_t b = (j < 8 ? h0 : h1b) + (j & 7) * 2 * lbo;
    pair_issue<NH, false>(j % 8 == 0, h, f, b, b + lo, lbo);
    wgmma_wait<1>();
    if (j == 7) {
      wgmma_wait<0>();
      pin<NH / 2>(h);
#pragma unroll
      for (int k = 0; k < NH / 2; ++k) hs[k] = h[k];
    }
  }
  wgmma_wait<0>();
  pin<NH / 2>(h);
#pragma unroll
  for (int k = 0; k < NH / 2; ++k) hs[k] += h[k];
#pragma unroll
  for (int jj = 0; jj < NH / 8; ++jj) {
    const int c = 8 * jj + 2 * t;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float* o = part + (size_t)(r + 8 * u) * ho + c;
      if (c + 1 < ho) {
        *reinterpret_cast<float2*>(o) = make_float2(hs[4 * jj + 2 * u], hs[4 * jj + 2 * u + 1]);
      } else if (c < ho) {
        o[0] = hs[4 * jj + 2 * u];
      }
    }
  }
}

struct PolicyArgs {
  const unsigned char* h1;   // linear1's output in the fragment layout
  const unsigned char* w2;   // pack_policy's W2 tiles: [col tile][chunk][hi | lo]
  const unsigned char* wh;   // its heads: [col tile][half][hi | lo], rows permuted
  const float* b2;
  float* part;               // (col tiles, rows_pad, ho) partial heads
  int rows_pad, hidden, ho;
  int col_tiles, total;      // a cluster's tiles: (rows_pad / PM_ROWS) x col_tiles
};

// grid = (2 x clusters,), clusters of PM_CLUSTER blocks along x,
// TC_CHAIN_THREADS threads. Shared memory: the barriers, PM_STAGES ring
// buffers, then h2's biases.
template <int NH>
__global__ void __launch_bounds__(TC_CHAIN_THREADS, 1) policy_mlp_kernel(const PolicyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);
  const uint32_t ring = bars + PM_BAR_BYTES;
  float* b2s = reinterpret_cast<float*>(smem + PM_BAR_BYTES + PM_STAGES * PM_STAGE_BYTES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < PM_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);  // full: the producer's expect_tx
      // empty: one arrive per consumer warp of both blocks (either may multicast into it)
      mbar_init(bars + 64 + 8 * s, PM_CLUSTER * TC_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < a.hidden; i += TC_CHAIN_THREADS) b2s[i] = a.b2[i];
  wide_cluster_sync();  // both blocks' barriers are set up before either copies or arrives
  const int rank = cluster_rank();
  const int cluster = blockIdx.x / PM_CLUSTER, clusters = gridDim.x / PM_CLUSTER;
  const int nc = a.hidden / PM_KC;
  const uint32_t head_bytes = 2 * 64 * NH * 4;  // a head buffer: 64 rows of NH, hi and lo
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 2) {  // the producer warpgroup: its first thread streams every tile's chunks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0;
      for (int tile = cluster; tile < a.total; tile += clusters) {
        const int m = tile / a.col_tiles, n = tile - m * a.col_tiles;
        // this block's 128 rows of h1's chunks; the half of W2's chunks
        // (hi: rank 0, lo: rank 1) that it multicasts to both blocks
        const unsigned char* src_a = a.h1 + ((size_t)m * nc * 2 + rank) * PM_A_BYTES;
        const unsigned char* src_b = a.w2 + (size_t)n * nc * PM_B_BYTES + rank * (PM_B_BYTES / 2);
        for (int c = 0; c < nc; ++c) {
          const int s = it % PM_STAGES;
          const uint32_t st = ring + s * PM_STAGE_BYTES;
          mbar_wait(bars + 64 + 8 * s, ((it / PM_STAGES) & 1) ^ 1);
          mbar_expect_tx(bars + 8 * s, PM_A_BYTES + PM_B_BYTES);
          bulk_load(st, src_a + (size_t)c * 2 * PM_A_BYTES, PM_A_BYTES, bars + 8 * s);
          bulk_load_multicast(st + PM_A_BYTES + rank * (PM_B_BYTES / 2),
                              src_b + (size_t)c * PM_B_BYTES, PM_B_BYTES / 2, bars + 8 * s,
                              (1u << PM_CLUSTER) - 1);
          ++it;
        }
        for (int half = 0; half < 2; ++half) {  // hi: rank 0, lo: rank 1
          const int s = it % PM_STAGES;
          mbar_wait(bars + 64 + 8 * s, ((it / PM_STAGES) & 1) ^ 1);
          mbar_expect_tx(bars + 8 * s, head_bytes);
          bulk_load_multicast(ring + s * PM_STAGE_BYTES + rank * (head_bytes / 2),
                              a.wh + (size_t)(2 * n + half) * head_bytes + rank * (head_bytes / 2),
                              head_bytes / 2, bars + 8 * s, (1u << PM_CLUSTER) - 1);
          ++it;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r = 16 * warp + (lane >> 2);
    uint32_t it = 0;
    for (int tile = cluster; tile < a.total; tile += clusters) {
      const int m = tile / a.col_tiles, n = tile - m * a.col_tiles;
      float acc[ACC_REGS], sum[ACC_REGS];  // this warpgroup's 64 rows: wgmma's, and the f32 sums
#pragma unroll
      for (int j = 0; j < ACC_REGS; ++j) sum[j] = 0.0f;
      uint32_t f0[8], f1[8];
      int prev = -1;
      for (int c = 0; c < nc; ++c) {
        const int s = it % PM_STAGES;
        mbar_wait(bars + 8 * s, (it / PM_STAGES) & 1);
        const unsigned char* abuf =
            smem + PM_BAR_BYTES + s * PM_STAGE_BYTES + wg * 2 * PM_FRAG_BYTES;
        const uint32_t b = ring + s * PM_STAGE_BYTES + PM_A_BYTES;
        const int first = c % (PM_FLUSH / 2) == 0;  // the first k-step after a flush overwrites acc
        policy_fragment(f0, abuf, warp, lane);
        pair_issue<PM_COLS, false>(first, acc, f0, b, b + PM_B_BYTES / 2, PM_B_LBO);
        wgmma_wait<1>();
        // the previous chunk's products are done: free its buffer in both blocks
        mbar_arrive_cluster(bars + 64 + 8 * max(prev, 0), PM_CLUSTER, lane == 0 && prev >= 0);
        policy_fragment(f1, abuf + PM_FRAG_BYTES, warp, lane);
        pair_issue<PM_COLS, false>(0, acc, f1, b + 2 * PM_B_LBO, b + 2 * PM_B_LBO + PM_B_BYTES / 2,
                                   PM_B_LBO);
        wgmma_wait<1>();
        prev = s;
        ++it;
        if (c % (PM_FLUSH / 2) == PM_FLUSH / 2 - 1) {  // flush: the window's sums into `sum`
          wgmma_wait<0>();
          pin<ACC_REGS>(acc);
#pragma unroll
          for (int j = 0; j < ACC_REGS; ++j) sum[j] += acc[j];
        }
      }
      mbar_arrive_cluster(bars + 64 + 8 * prev, PM_CLUSTER, lane == 0);
      // the heads of the tile's 128 columns: two more ring buffers
      const int s0 = it % PM_STAGES, s1 = (it + 1) % PM_STAGES;
      mbar_wait(bars + 8 * s0, (it / PM_STAGES) & 1);
      mbar_wait(bars + 8 * s1, ((it + 1) / PM_STAGES) & 1);
      const size_t row0 = (size_t)m * PM_ROWS + rank * PM_BLOCK_ROWS + 64 * wg;
      policy_heads<NH>(sum, b2s + n * PM_COLS, ring + s0 * PM_STAGE_BYTES,
                       ring + s1 * PM_STAGE_BYTES, a.part + ((size_t)n * a.rows_pad + row0) * a.ho,
                       a.ho, r, lane);
      mbar_arrive_cluster(bars + 64 + 8 * s0, PM_CLUSTER, lane == 0);
      mbar_arrive_cluster(bars + 64 + 8 * s1, PM_CLUSTER, lane == 0);
      it += 2;
    }
  }
  wide_cluster_sync();  // no block leaves while its peer may still copy into it or arrive
}

// The partial heads summed over the column tiles in order, the heads' biases
// added, log_std clamped to [LOG_SIG_MIN, LOG_SIG_MAX] (a NaN stays NaN, as
// torch.clamp leaves it). One thread an output.
__global__ void policy_heads_kernel(const float* __restrict__ part, const float* __restrict__ bh,
                                    float* __restrict__ mean, float* __restrict__ log_std,
                                    int rows, int rows_pad, int act, int col_tiles) {
  const int ho = 2 * act;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * ho) return;
  const int row = (int)(i / ho), j = (int)(i - (long long)row * ho);
  float s = 0.0f;
  for (int n = 0; n < col_tiles; ++n) s += part[((size_t)n * rows_pad + row) * ho + j];
  s += bh[j];
  if (j < act) {
    mean[(size_t)row * act + j] = s;
  } else {
    log_std[(size_t)row * act + j - act] = s < -20.0f ? -20.0f : s > 2.0f ? 2.0f : s;
  }
}

template <int NH>
static cudaError_t launch_policy_mlp(int blocks, size_t smem, cudaStream_t stream,
                                     const PolicyArgs& a) {
  const cudaError_t err = prepare_once<policy_mlp_kernel<NH>>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PM_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(TC_CHAIN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, policy_mlp_kernel<NH>, a);
}

extern "C" {

// x (rows, din) row-major; w1, w2 and wh pack_policy's tiles; h1 a scratch
// of rows_pad x hidden floats, part one of col_tiles x rows_pad x 2 act
// floats, rows_pad = rows rounded up to PM_ROWS; mean and
// log_std (rows, act). `blocks` is the main kernel's grid: clusters of
// PM_CLUSTER blocks, at most one a tile. hidden a multiple of PM_COLS up to
// PM_MAX_HIDDEN, din up to PM_MAX_IN, 2 act up to PM_HEAD_MAX.
int mbrl_policy_mlp(const float* x, const void* w1, const float* b1, const void* w2,
                    const float* b2, const void* wh, const float* bh, float* h1, float* part,
                    float* mean, float* log_std, int rows, int din, int hidden, int act,
                    int blocks, void* stream) {
  if (rows < 1 || din < 1 || din > PM_MAX_IN || hidden < PM_COLS || hidden % PM_COLS != 0 ||
      hidden > PM_MAX_HIDDEN || act < 1 || 2 * act > PM_HEAD_MAX)
    return cudaErrorInvalidValue;
  const int row_blocks = (rows + PM_ROWS - 1) / PM_ROWS;
  const int col_tiles = hidden / PM_COLS;
  const long long total = (long long)row_blocks * col_tiles;
  if (blocks < PM_CLUSTER || blocks % PM_CLUSTER != 0 || blocks / PM_CLUSTER > total ||
      total > INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const size_t l1_smem = 128 + 2 * sizeof(float) * (size_t)((din + 7) / 8 * 8) * PM_COLS;
  static const cudaError_t l1_err =
      prepare(policy_linear1_kernel, 128 + 2 * sizeof(float) * PM_MAX_IN * PM_COLS);
  if (l1_err != cudaSuccess) return l1_err;
  policy_linear1_kernel<<<dim3(row_blocks, col_tiles), PM_L1_THREADS, l1_smem, s>>>(
      x, static_cast<const unsigned char*>(w1), b1, h1, rows, din, hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const PolicyArgs a{reinterpret_cast<const unsigned char*>(h1),
                     static_cast<const unsigned char*>(w2), static_cast<const unsigned char*>(wh),
                     b2, part, row_blocks * PM_ROWS, hidden, 2 * act, col_tiles, (int)total};
  const size_t smem = PM_BAR_BYTES + (size_t)PM_STAGES * PM_STAGE_BYTES + sizeof(float) * hidden;
  const int nh = (2 * act + 15) / 16 * 16;
  switch (nh) {
    case 16: err = launch_policy_mlp<16>(blocks, smem, s, a); break;
    case 32: err = launch_policy_mlp<32>(blocks, smem, s, a); break;
    case 48: err = launch_policy_mlp<48>(blocks, smem, s, a); break;
    case 64: err = launch_policy_mlp<64>(blocks, smem, s, a); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long outs = (long long)rows * 2 * act;
  policy_heads_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(
      part, bh, mean, log_std, rows, row_blocks * PM_ROWS, act, col_tiles);
  return cudaGetLastError();
}

}  // extern "C"
