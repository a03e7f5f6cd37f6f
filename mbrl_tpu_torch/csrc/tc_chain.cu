// The rollout kernels K1 and K2 on Hopper's tensor cores (sm_90a), written by hand.
//
// Replaces two Pallas TPU kernels of mbrl_tpu/ops/pallas_kernels.py:
//   K1 rollout_returns_tc_kernel <- fused_rollout_returns / _rollout_kernel
//                                   (whole H-step imagined rollout, one launch)
//   K2 gaussian_tc_kernel        <- fused_ensemble_mlp_gaussian / _gaussian_kernel
//                                   (one rollout step: MLP chain + bounded
//                                   Gaussian head + Box-Muller sample)
// Both run the member's layer chain through one routine: produce_chain() on
// the producer warpgroup's first thread and consume_chain() on two consumer
// warpgroups (tc_chain.cuh, shared with K3 in ensemble_mlp.cu).
//
// What bounds them: at the main path's shapes, one tile's chain of products
// and epilogues on one SM. A launch is under one wave (110 blocks at E's
// 5 x 1,400 rows, 125 at B's and A's), so it takes one 64-row tile's
// critical path. The floor for the tensor work alone (derived): at E, 64 x
// 122,600 MACs x 2 x 3 (3xTF32) at 495/132 TFLOP/s is 12.6 us a tile; at A,
// 64 x 131,800 x 2 in bf16 at 989/132 TFLOP/s is 2.25 us a step. Measured
// on an H100 (ops/chain_timeline.py): a 200 x 200 layer's products take 6.4
// us in f32 and 2.2 us in bf16, no faster on two accumulators than on one,
// and a launch is within 10% of it with no weight copies at all; the
// epilogues (bias, silu, the next A operand) take 2.2 and 1.8 us each.
//
// Design.
// - Weights are packed once per rollout (ops/kernels.py: pack_chain) into
//   chunks that are already in wgmma's shared-memory layout: K-major, no
//   swizzle, 8-row x 16-byte core matrices, zero padding. One 1-D bulk async
//   copy (cp.async.bulk ... mbarrier::complete_tx) lands a chunk: no tensor
//   map, no libcuda.
// - A block is TC_CHAIN_THREADS: two consumer warpgroups and a producer
//   warpgroup. Its first thread keeps a ring of up to TC_MAX_STAGES chunk
//   buffers in flight, tracked by full/empty mbarriers, so the next chunk's
//   copy overlaps the current chunk's products; in K1 it runs ahead into the
//   next step's chunks. Its last three warps draw the Gaussian head's normals
//   (Philox4x32-10 and Box-Muller, gaussian_head.cuh) into shared memory
//   while the consumers multiply: the normals depend only on their counters
//   and the key, never on the head. K2 draws its tile's at once; K1 a step's
//   into one of two buffers, up to two steps ahead (noise_full/noise_empty
//   mbarriers). After the head only the bounded log-variance, one exp and
//   one FMA an output are left. (Three warps beside the eight consumer warps
//   cost no registers: any block past eight warps puts three warps on one of
//   the SM's four register files, which caps a thread at 168 registers.)
// - The two consumer warpgroups issue wgmma.mma_async with the activations
//   (A) and the weight chunk (B) both in shared memory and f32 accumulators
//   in registers. A hidden layer is split by N: each warpgroup takes half of
//   the columns (8..128, a compile-time case). A narrow head (<=
//   TC_HEAD_SPLIT columns: 75 dependent N = 8 instructions on warpgroup 0
//   alone at E) is split by K instead: both warpgroups take all its columns
//   and every other k-step, and leave two partial tiles that head_at adds.
//   The chain takes layers up to 256 wide and at most MAX_PRODUCTS products;
//   the wrappers send any other stack down the wide route (wide_tc.cu,
//   ensemble_mlp_wide.cu).
// - A ring buffer holds as many whole chunks of a product as fit
//   (ring_chunks), one bulk copy: a narrow head's 13 chunks of 16 rows (f32)
//   wait for one copy, not for 13 round trips of the ring.
// - Each chunk is one pipeline stage (fence, products, commit), straight-line
//   and on warp-uniform control flow. ptxas serializes wgmma (a wait before
//   every one) when a stage depends on a path it must treat as divergent, when
//   one register array holds accumulators of two widths at two offsets, and
//   when the accumulators do not fit the 168 registers a thread has; so the
//   role split and the warpgroup index are broadcast with __shfl_sync, the
//   barrier wait loops in PTX, arrivals are predicated, every product's
//   accumulators are one prefix of one array, and a product's first step
//   overwrites them (scale-d = 0) instead of zeroing. `nvcc -Xptxas -v`
//   shows C7519 only and no spill.
// - bf16 stacks: m64nNk16 bf16 products; the activations are rounded to bf16
//   where the TPU kernels round them (kernel input, every hidden activation).
// - f32 stacks: 3xTF32 on m64nNk8 tf32 products, a_hi*w_hi + a_hi*w_lo +
//   a_lo*w_hi with hi = rna_tf32(v) and lo = rna_tf32(v - hi), which keeps
//   f32-grade results (never plain TF32). wgmma takes tf32 operands only
//   K-major, which is the packed layout. The epilogue writes a_lo next to a_hi.
// - Epilogues run in registers: bias, then the activation, then the next
//   layer's A operand in shared memory; the head goes to shared memory (over
//   the A region, which is free by then) for the Gaussian sample. In bf16 a
//   hidden epilogue is compiled for a few widths (store_hidden), with no
//   branch between column groups, so their activations overlap; in f32 the
//   same measured slower, and it keeps the loop over the groups.
//
// Sampling: counter-based Philox4x32-10 keyed on two seed words from the
// wrapper, counting on (row, column, 0, member) in K2 and (row, column, step,
// tile) in K1, so a seed draws the same normals as the in-line sampler did.
//
// ops/chain_timeline.py times each phase of one block (-DTC_TIMELINE).
//
// Plain C interface, loaded with ctypes. Every entry returns
// cudaGetLastError() after its launch.

#include "gaussian_head.cuh"
#include "tc_chain.cuh"

#ifdef TC_TIMELINE
// Copies the marks out and clears them for the next launch.
extern "C" int mbrl_timeline(unsigned long long* out) {
  static const unsigned long long zero[96] = {};
  const cudaError_t err = cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(tc_timeline, zero, sizeof(zero));
}
#endif

// The normals of one tile, drawn by the producer warpgroup's last
// TC_NOISE_THREADS threads (thread k: entries k, k + TC_NOISE_THREADS, ...)
// into `noise` (rows, out_size); entry (r, c) at counter (row0 + r, c, c2,
// c3), the one head_draw uses. Then every one of them arrives on `bar`.
__device__ __forceinline__ void draw_normals(float* noise, int n, int out_size, uint32_t row0,
                                             uint32_t c2, uint32_t c3, uint2 key, uint32_t bar) {
  for (int idx = threadIdx.x - (TC_CONSUMERS + 32); idx < n; idx += TC_NOISE_THREADS) {
    const int r = idx / out_size, c = idx - r * out_size;
    noise[idx] = head_normal(make_uint4(row0 + r, (uint32_t)c, c2, c3), key);
  }
  TC_STAMP_AT(64 + 26, threadIdx.x == TC_CONSUMERS + 32)  // the normals drawn
  mbar_arrive(bar, true);
}

// ---------------------------------------------------------------------------
// K2: one rollout step. grid = (ceil(S / TC_ROWS), E), TC_CHAIN_THREADS threads.
// x (E, S, in) f32 -> out (E, S, out_size) f32: a draw from the bounded
// Gaussian head, or its mean when sample == 0. Shared memory past the ring:
// the logvar bounds, then the tile's (rows, out_size) normals.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(TC_CHAIN_THREADS, 1)
gaussian_tc_kernel(uint32_t seed0, uint32_t seed1, const float* __restrict__ x,
                   const unsigned char* __restrict__ ws, const float* __restrict__ bs,
                   const float* __restrict__ max_lv, const float* __restrict__ min_lv,
                   float* __restrict__ out, const ChainDesc d, int S, int out_size, int sample) {
  extern __shared__ __align__(128) unsigned char smem[];
  TC_STAMP(0)
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * TC_ROWS;
  const int rows = min(TC_ROWS, S - row0);
  init_barriers(d, smem);
  TC_STAMP(1)
  float* lvb = reinterpret_cast<float*>(smem + d.extra_off);  // max, then min logvar
  float* noise = lvb + TC_BOUNDS_BYTES / 4;
  const uint32_t noise_bar = smem_u32(smem) + TC_NOISE_FULL;
  if (__shfl_sync(0xffffffffu, threadIdx.x, 0) >= TC_CONSUMERS) {  // the producer warpgroup
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0;
      produce_chain<BF16>(d, smem, ws + (size_t)e * d.w_member * TC<BF16>::ESIZE, it);
    } else if (threadIdx.x >= TC_CONSUMERS + 32 && sample) {
      draw_normals(noise, rows * out_size, out_size, (uint32_t)row0, 0u, (uint32_t)e,
                   make_uint2(seed0, seed1), noise_bar);
    }
    return;
  }
  unsigned char* a_buf = smem + TC_BARRIER_BYTES;
  const int din = d.dims[0], k0 = d.kp[0];
  const float* xe = x + ((size_t)e * S + row0) * din;
  if (threadIdx.x < out_size) {
    lvb[threadIdx.x] = max_lv[threadIdx.x];
    lvb[128 + threadIdx.x] = min_lv[threadIdx.x];
  }
  for (int idx = threadIdx.x; idx < TC_ROWS * k0; idx += TC_CONSUMERS) {
    const int r = idx / k0, c = idx - r * k0;
    store_a<BF16>(a_buf, d.a_copy_bytes, r, c, r < rows && c < din ? xe[(size_t)r * din + c] : 0.0f);
  }
  fence_proxy_async();
  consumer_sync();
  TC_STAMP(2)
  uint32_t it = 0;
  consume_chain<ACT, BF16>(d, smem, bs + (size_t)e * d.b_member, it);

  if (sample) mbar_wait(noise_bar, 0);
  TC_STAMP(26)  // the normals ready for the consumers
  const float* head = reinterpret_cast<const float*>(a_buf);
  float* o = out + ((size_t)e * S + row0) * out_size;
  for (int idx = threadIdx.x; idx < rows * out_size; idx += TC_CONSUMERS) {
    const int r = idx / out_size, c = idx - r * out_size;
    const float mean = head_at(d, head, r, c);
    o[idx] = sample ? head_draw_z(mean, head_at(d, head, r, out_size + c), lvb[c], lvb[128 + c],
                                  noise[idx])
                    : mean;
  }
  TC_STAMP(31)
}

// ---------------------------------------------------------------------------
// K1: the whole H-step rollout. grid = (num_tiles,), one block per row tile
// of `tile` (<= TC_ROWS) rows, looping over the steps inside the block. The
// obs carry and the running total stay in shared memory for all H steps; per
// step only the (tile, A) action slab is read from device memory. Row tile i
// uses member ((i + rot[t]) % num_tiles) / tiles_per_member at step t. The
// producer warpgroup's noise threads draw step t's normals into buffer t % 2
// up to two steps ahead; the consumers free it after step t's sampling.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(TC_CHAIN_THREADS, 1)
rollout_returns_tc_kernel(uint32_t seed0, uint32_t seed1, const int* __restrict__ rot,
                          const float* __restrict__ obs0, const float* __restrict__ acts,
                          const float* __restrict__ dmask, const unsigned char* __restrict__ ws,
                          const float* __restrict__ bs, const float* __restrict__ max_lv,
                          const float* __restrict__ min_lv, float* __restrict__ out,
                          const ChainDesc d, int obs_dim, int act_dim, int horizon, int out_size,
                          int tile, int num_tiles, int tiles_per_member, int sample) {
  extern __shared__ __align__(128) unsigned char smem[];
  TC_STAMP(0)
  const int i = blockIdx.x;
  const int row0 = i * tile;
  init_barriers(d, smem);
  TC_STAMP(1)
  float* lvb = reinterpret_cast<float*>(smem + d.extra_off);  // max, then min logvar
  float* obs = lvb + TC_BOUNDS_BYTES / 4;                     // (TC_ROWS, obs_dim) carry
  float* total = obs + TC_ROWS * obs_dim;                     // (TC_ROWS,) running return
  float* noise = total + TC_ROWS;                             // 2 x (TC_ROWS, out_size)
  const uint32_t bars = smem_u32(smem);
  if (__shfl_sync(0xffffffffu, threadIdx.x, 0) >= TC_CONSUMERS) {  // the producer warpgroup
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0;
      for (int t = 0; t < horizon; ++t) {
        const int m = ((i + rot[t]) % num_tiles) / tiles_per_member;
        produce_chain<BF16>(d, smem, ws + (size_t)m * d.w_member * TC<BF16>::ESIZE, it);
      }
    } else if (threadIdx.x >= TC_CONSUMERS + 32 && sample) {
      for (int t = 0; t < horizon; ++t) {
        const int buf = t & 1;
        // buffer `buf` was last read at step t - 2
        if (t >= 2) mbar_wait(bars + TC_NOISE_EMPTY + 8 * buf, ((t >> 1) - 1) & 1);
        draw_normals(noise + buf * TC_ROWS * out_size, tile * out_size, out_size, (uint32_t)row0,
                     (uint32_t)t, (uint32_t)i, make_uint2(seed0, seed1),
                     bars + TC_NOISE_FULL + 8 * buf);
      }
    }
    return;
  }
  unsigned char* a_buf = smem + TC_BARRIER_BYTES;
  const float* head = reinterpret_cast<const float*>(a_buf);
  const int din = obs_dim + act_dim, k0 = d.kp[0];

  for (int idx = threadIdx.x; idx < tile * obs_dim; idx += TC_CONSUMERS)
    obs[idx] = obs0[(size_t)row0 * obs_dim + idx];
  for (int r = threadIdx.x; r < TC_ROWS; r += TC_CONSUMERS) total[r] = 0.0f;
  if (threadIdx.x < out_size) {
    lvb[threadIdx.x] = max_lv[threadIdx.x];
    lvb[128 + threadIdx.x] = min_lv[threadIdx.x];
  }
  consumer_sync();

  uint32_t it = 0;
  for (int t = 0; t < horizon; ++t) {
    TC_STAMP(28)  // the step's start (the marks of the last step are read)
    const int m = ((i + rot[t]) % num_tiles) / tiles_per_member;
    const int buf = t & 1;
    // x = concat(obs, act_t), zero past the tile and past din
    for (int idx = threadIdx.x; idx < TC_ROWS * k0; idx += TC_CONSUMERS) {
      const int r = idx / k0, c = idx - r * k0;
      float v = 0.0f;
      if (r < tile && c < din) {
        v = c < obs_dim ? obs[r * obs_dim + c]
                        : acts[((size_t)(row0 + r) * horizon + t) * act_dim + (c - obs_dim)];
      }
      store_a<BF16>(a_buf, d.a_copy_bytes, r, c, v);
    }
    fence_proxy_async();
    consumer_sync();
    TC_STAMP(2)
    consume_chain<ACT, BF16>(d, smem, bs + (size_t)m * d.b_member, it);
    if (sample) mbar_wait(bars + TC_NOISE_FULL + 8 * buf, (t >> 1) & 1);
    TC_STAMP(26)  // the step's normals ready for the consumers
    // one thread per (row, output column): the last column is the learned
    // reward, the others are delta (dmask = 1) or absolute next-obs targets
    const float* nz = noise + buf * TC_ROWS * out_size;
    for (int idx = threadIdx.x; idx < tile * out_size; idx += TC_CONSUMERS) {
      const int r = idx / out_size, c = idx - r * out_size;
      const float mean = head_at(d, head, r, c);
      const float pred = sample ? head_draw_z(mean, head_at(d, head, r, out_size + c), lvb[c],
                                              lvb[128 + c], nz[idx])
                                : mean;
      if (c < out_size - 1) {
        const float dm = dmask[c];
        obs[r * obs_dim + c] = dm * (obs[r * obs_dim + c] + pred) + (1.0f - dm) * pred;
      } else {
        total[r] += pred;
      }
    }
    TC_STAMP(31)
    consumer_sync();
    if (sample) mbar_arrive(bars + TC_NOISE_EMPTY + 8 * buf, threadIdx.x == 0);
  }
  for (int r = threadIdx.x; r < tile; r += TC_CONSUMERS) out[row0 + r] = total[r];
  TC_STAMP(30)
}

// ---------------------------------------------------------------------------
// Host side

#define LAUNCH_K2(ACT, BF16, grid, smem, stream, ...)                                  \
  {                                                                                    \
    cudaError_t err = prepare_once<gaussian_tc_kernel<ACT, BF16>>();                   \
    if (err != cudaSuccess) return err;                                                \
    gaussian_tc_kernel<ACT, BF16><<<grid, TC_CHAIN_THREADS, smem, stream>>>(__VA_ARGS__);    \
  }

#define LAUNCH_K1(ACT, BF16, grid, smem, stream, ...)                                  \
  {                                                                                    \
    cudaError_t err = prepare_once<rollout_returns_tc_kernel<ACT, BF16>>();            \
    if (err != cudaSuccess) return err;                                                \
    rollout_returns_tc_kernel<ACT, BF16><<<grid, TC_CHAIN_THREADS, smem, stream>>>(__VA_ARGS__); \
  }

extern "C" {

// `tiles` is pack_chain()'s weight tensor; `tile_elems` its elements per
// member, checked against this side's layout.
int mbrl_ensemble_mlp_gaussian(unsigned int seed0, unsigned int seed1, const float* x,
                               const void* tiles, const float* bs, const float* max_lv,
                               const float* min_lv, float* out, const int* dims,
                               int num_products, int num_members, int rows, int out_size,
                               int sample, int act, int bf16, long long tile_elems,
                               void* stream) {
  ChainDesc d;
  size_t smem;
  const int noise = (int)sizeof(float) * TC_ROWS * out_size;  // the tile's normals
  if (out_size < 1 || !make_chain_desc(bf16, dims, num_products, noise, &d, &smem) || rows < 1 ||
      num_members < 1 || d.dims[num_products] != 2 * out_size || d.w_member != tile_elems)
    return cudaErrorInvalidValue;
  const dim3 grid((rows + TC_ROWS - 1) / TC_ROWS, num_members);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* ws = static_cast<const unsigned char*>(tiles);
  DISPATCH(act, bf16, LAUNCH_K2, grid, smem, s, seed0, seed1, x, ws, bs, max_lv, min_lv, out, d,
           rows, out_size, sample)
  return cudaGetLastError();
}

int mbrl_rollout_returns(unsigned int seed0, unsigned int seed1, const int* rot,
                         const float* obs0, const float* acts, const float* dmask,
                         const void* tiles, const float* bs, const float* max_lv,
                         const float* min_lv, float* out, const int* dims, int num_products,
                         int num_members, int batch, int obs_dim, int act_dim, int horizon,
                         int out_size, int tile, int sample, int act, int bf16,
                         long long tile_elems, void* stream) {
  ChainDesc d;
  size_t smem;
  // the obs carry, the running return and two buffers of a step's normals
  const int extra = (int)sizeof(float) * TC_ROWS * (obs_dim + 1 + 2 * out_size);
  if (!make_chain_desc(bf16, dims, num_products, extra, &d, &smem) ||
      d.dims[num_products] != 2 * out_size || d.dims[0] != obs_dim + act_dim ||
      obs_dim != out_size - 1 || tile < 1 || tile > TC_ROWS || batch % tile != 0 ||
      d.w_member != tile_elems)
    return cudaErrorInvalidValue;
  const int num_tiles = batch / tile;
  if (num_tiles % num_members != 0) return cudaErrorInvalidValue;
  const int tiles_per_member = num_tiles / num_members;
  const dim3 grid(num_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* ws = static_cast<const unsigned char*>(tiles);
  DISPATCH(act, bf16, LAUNCH_K1, grid, smem, s, seed0, seed1, rot, obs0, acts, dmask, ws, bs,
           max_lv, min_lv, out, d, obs_dim, act_dim, horizon, out_size, tile, num_tiles,
           tiles_per_member, sample)
  return cudaGetLastError();
}

}  // extern "C"
