// The wide route of the rollout kernels K1 and K2 on Hopper's tensor cores
// (sm_90a), written by hand.
//
// Replaces, for every stack the tensor-core chain (tc_chain.cu) does not take
// (kernels.takes_chain: a layer wider than 256 columns, more than
// MAX_PRODUCTS products, or no room for the chain's ring), two Pallas TPU
// kernels of mbrl_tpu/ops/pallas_kernels.py:
//   K1 rollout_returns_wide_tc_kernel <- fused_rollout_returns / _rollout_kernel
//                                        (whole H-step imagined rollout, one launch)
//   K2 gaussian_wide_tc_kernel        <- fused_ensemble_mlp_gaussian / _gaussian_kernel
//                                        (one step: MLP chain + bounded Gaussian sample)
// Widest layer and deepest chain it takes: any. K3's wide route runs on the
// same products (ensemble_mlp_wide.cu).
//
// What bounds them: operations, the products at the tensor peak (bf16 989
// TFLOP/s; an f32 stack as 3xTF32, three tf32 products at 495). At 512 columns
// a 64-row tile needs 64 x 817,152 MACs a step, and a member's stack as tf32
// hi/lo pairs is 6.5 MB, so every block streams its member's weights from L2
// at every step; a 64 x 512 f32 activation as hi/lo is 256 KB, more than a
// block's 227 KB of shared memory, so the activations stream too.
//
// Design (the chain's family, tc_chain.cuh, without its width and depth limits):
// - Same grids as the route it replaces: K2 one block per (64-row tile,
//   member), K1 one block per row tile looping over the steps; one launch a
//   wrapper call. 288 threads: two consumer warpgroups and one producer warp.
// - Products on wgmma: bf16 m64nNk16 for a bf16 stack; 3xTF32 on m64nNk8 for
//   an f32 stack (a_hi w_hi + a_hi w_lo + a_lo w_hi), so f32-grade results.
// - Each product runs in passes of up to WT_PASS = 256 output columns, one
//   half per warpgroup with its 64 accumulators in registers, over K chunks of
//   16 (f32) or 64 (bf16) rows.
// - Weights are packed once per model state (ops/kernels.py:pack_wide,
//   WideTileLayout; mirrored by make_wide_desc): per product, per pass, per K
//   chunk, in wgmma's unswizzled K-major B layout, zero-padded, f32 as tf32 hi
//   and lo copies.
// - Activations live in a per-block scratch in device memory (the wrapper
//   allocates it): two buffers, the product's input and output in turn, each
//   already in the layout an A chunk lands in (a_index, chunk after chunk,
//   hi then lo). The epilogue applies bias, activation and bf16 rounding and
//   writes the next product's A operand there; the head goes there as f32.
// - One producer thread keeps a ring of up to TC_MAX_STAGES buffers in
//   flight, each one bulk copy of a weight chunk and one of the activation
//   chunk beside it (cp.async.bulk + mbarrier complete_tx), so loads overlap
//   the products of the chunks before. Between products the activations make
//   a round trip through device memory: the consumers' stores are generic-
//   proxy writes, so every consumer thread fences them
//   (fence.proxy.async.global) and arrives on a ready barrier that the
//   producer waits on before it copies the product's first activation chunk;
//   that chunk's weights are already in flight.
// - Control flow stays warp-uniform (the dims come from device memory through
//   __shfl_sync), so ptxas keeps the wgmma pipelined.
// - Heads as the chain's: the bounded log-variance and the Gaussian draw with
//   the same Philox counters (gaussian_head.cuh): (row, column, 0, member) in
//   K2, (row, column, step, tile) in K1, so a draw is the same function of the
//   seed on every route. K1's obs carry and running return live in the scratch.
//
// Plain C interface, loaded with ctypes. Every entry returns
// cudaGetLastError() after its launch.

#include "gaussian_head.cuh"
#include "wide_tc.cuh"

#ifdef TC_TIMELINE
// Marks of K2's block (0, 0) (and of K1's block 0, where K1 ran last): 0
// start, 1 barriers set up, 2 input staged, produce_wide's and consume_wide's
// per product (wide_tc.cuh), 31 sampled.
extern "C" int mbrl_timeline_wide(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
}
#endif

// ---------------------------------------------------------------------------
// K2: one rollout step. grid = (ceil(S / TC_ROWS), E), TC_THREADS threads.
// x (E, S, in) f32 -> out (E, S, out_size) f32: a draw from the bounded
// Gaussian head, or its mean when sample == 0.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(TC_THREADS, 1)
gaussian_wide_tc_kernel(uint32_t seed0, uint32_t seed1, const float* __restrict__ x,
                        const unsigned char* __restrict__ ws, const float* __restrict__ bs,
                        const float* __restrict__ max_lv, const float* __restrict__ min_lv,
                        float* __restrict__ out, const int* __restrict__ dims, const WideDesc d,
                        unsigned char* scratch, int S, int out_size, int sample) {
  extern __shared__ __align__(128) unsigned char smem[];
  TC_STAMP(0)
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * TC_ROWS;
  const int rows = min(TC_ROWS, S - row0);
  unsigned char* act = scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * d.block_bytes;
  init_wide_barriers(d, smem);
  TC_STAMP(1)
  if (uniform(threadIdx.x) >= TC_CONSUMERS) {  // the producer warp
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0, ready = 0;
      produce_wide<BF16>(d, dims, smem, ws + (size_t)e * d.w_member * TC<BF16>::ESIZE, act, it,
                         ready);
    }
    return;
  }
  const int din = __ldg(dims);
  const float* xe = x + ((size_t)e * S + row0) * din;
  stage_wide_input<BF16>(smem, act, din, [&](int r, int c) {
    return r < rows ? __ldg(xe + (size_t)r * din + c) : 0.0f;
  });
  TC_STAMP(2)
  float* head = reinterpret_cast<float*>(act + d.head_off);
  uint32_t it = 0;
  consume_wide<ACT, BF16>(d, dims, smem, act, head, bs + (size_t)e * d.b_member, it);

  const uint2 key = make_uint2(seed0, seed1);
  float* o = out + ((size_t)e * S + row0) * out_size;
  for (int idx = threadIdx.x; idx < rows * out_size; idx += TC_CONSUMERS) {
    const int r = idx / out_size, c = idx - r * out_size;
    const uint4 ctr = make_uint4((uint32_t)(row0 + r), (uint32_t)c, 0u, (uint32_t)e);
    o[idx] = head_draw(head[r * d.head_ld + c], head[r * d.head_ld + out_size + c],
                       __ldg(max_lv + c), __ldg(min_lv + c), sample, ctr, key);
  }
  TC_STAMP(31)
}

// ---------------------------------------------------------------------------
// K1: the whole H-step rollout. grid = (num_tiles,), one block per row tile
// of `tile` (<= TC_ROWS) rows, looping over the steps inside the block; row
// tile i uses member ((i + rot[t]) % num_tiles) / tiles_per_member at step t.
// The obs carry and the running return stay in the block's scratch; per step
// only the (tile, A) action slab is read from the inputs.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(TC_THREADS, 1)
rollout_returns_wide_tc_kernel(uint32_t seed0, uint32_t seed1, const int* __restrict__ rot,
                               const float* __restrict__ obs0, const float* __restrict__ acts,
                               const float* __restrict__ dmask,
                               const unsigned char* __restrict__ ws, const float* __restrict__ bs,
                               const float* __restrict__ max_lv, const float* __restrict__ min_lv,
                               float* __restrict__ out, const int* __restrict__ dims,
                               const WideDesc d, unsigned char* scratch, int obs_dim, int act_dim,
                               int horizon, int out_size, int tile, int num_tiles,
                               int tiles_per_member, int sample) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int i = blockIdx.x;
  const int row0 = i * tile;
  unsigned char* act = scratch + (size_t)i * d.block_bytes;
  init_wide_barriers(d, smem);
  if (uniform(threadIdx.x) >= TC_CONSUMERS) {  // the producer warp
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0, ready = 0;
      for (int t = 0; t < horizon; ++t) {
        const int m = ((i + rot[t]) % num_tiles) / tiles_per_member;
        produce_wide<BF16>(d, dims, smem, ws + (size_t)m * d.w_member * TC<BF16>::ESIZE, act, it,
                           ready);
      }
    }
    return;
  }
  float* head = reinterpret_cast<float*>(act + d.head_off);
  float* obs = reinterpret_cast<float*>(act + d.carry_off);  // (TC_ROWS, obs_dim)
  float* total = obs + TC_ROWS * obs_dim;                    // (TC_ROWS,)
  const int din = obs_dim + act_dim;
  const uint2 key = make_uint2(seed0, seed1);
  for (int idx = threadIdx.x; idx < tile * obs_dim; idx += TC_CONSUMERS)
    obs[idx] = obs0[(size_t)row0 * obs_dim + idx];
  for (int r = threadIdx.x; r < TC_ROWS; r += TC_CONSUMERS) total[r] = 0.0f;
  consumer_sync();

  uint32_t it = 0;
  for (int t = 0; t < horizon; ++t) {
    const int m = ((i + rot[t]) % num_tiles) / tiles_per_member;
    // x = concat(obs, act_t), zero past the tile
    stage_wide_input<BF16>(smem, act, din, [&](int r, int c) {
      if (r >= tile) return 0.0f;
      return c < obs_dim ? obs[r * obs_dim + c]
                         : __ldg(acts + ((size_t)(row0 + r) * horizon + t) * act_dim + (c - obs_dim));
    });
    consume_wide<ACT, BF16>(d, dims, smem, act, head, bs + (size_t)m * d.b_member, it);
    // one thread per (row, output column): the last column is the learned
    // reward, the others are delta (dmask = 1) or absolute next-obs targets
    for (int idx = threadIdx.x; idx < tile * out_size; idx += TC_CONSUMERS) {
      const int r = idx / out_size, c = idx - r * out_size;
      const uint4 ctr = make_uint4((uint32_t)(row0 + r), (uint32_t)c, (uint32_t)t, (uint32_t)i);
      const float pred = head_draw(head[r * d.head_ld + c], head[r * d.head_ld + out_size + c],
                                   __ldg(max_lv + c), __ldg(min_lv + c), sample, ctr, key);
      if (c < out_size - 1) {
        const float dm = __ldg(dmask + c);
        obs[r * obs_dim + c] = dm * (obs[r * obs_dim + c] + pred) + (1.0f - dm) * pred;
      } else {
        total[r] += pred;
      }
    }
    consumer_sync();  // the carry is whole before the next step reads it
  }
  for (int r = threadIdx.x; r < tile; r += TC_CONSUMERS) out[row0 + r] = total[r];
}

// ---------------------------------------------------------------------------
// Host side

#define LAUNCH_K2WT(ACT, BF16, grid, smem, stream, ...)                                  \
  {                                                                                      \
    cudaError_t err = prepare_once<gaussian_wide_tc_kernel<ACT, BF16>>();                \
    if (err != cudaSuccess) return err;                                                  \
    gaussian_wide_tc_kernel<ACT, BF16><<<grid, TC_THREADS, smem, stream>>>(__VA_ARGS__); \
  }

#define LAUNCH_K1WT(ACT, BF16, grid, smem, stream, ...)                                         \
  {                                                                                             \
    cudaError_t err = prepare_once<rollout_returns_wide_tc_kernel<ACT, BF16>>();                \
    if (err != cudaSuccess) return err;                                                         \
    rollout_returns_wide_tc_kernel<ACT, BF16><<<grid, TC_THREADS, smem, stream>>>(__VA_ARGS__); \
  }

extern "C" {

// Both entries take the stack's dims twice: `dims` on the host (checked here,
// sizes the layout and the scratch) and `dims_dev`, the same ints in device
// memory (read by the kernel). `tiles` is pack_wide()'s weight tensor with
// `tile_elems` elements per member, checked against this side's layout;
// `scratch` holds `scratch_bytes`, at least the grid's blocks x block_bytes
// (ops/kernels.py:WideTileLayout.block_bytes).
int mbrl_ensemble_mlp_gaussian_wide(unsigned int seed0, unsigned int seed1, const float* x,
                                    const void* tiles, const float* bs, const float* max_lv,
                                    const float* min_lv, float* out, const int* dims,
                                    const int* dims_dev, int num_products, int num_members,
                                    int rows, int out_size, int sample, int act, int bf16,
                                    long long tile_elems, void* scratch, long long scratch_bytes,
                                    void* stream) {
  WideDesc d;
  size_t smem;
  if (!make_wide_desc(bf16, dims, num_products, 0, &d, &smem) || rows < 1 || num_members < 1 ||
      dims[num_products] != 2 * out_size || d.w_member != tile_elems)
    return cudaErrorInvalidValue;
  const dim3 grid((rows + TC_ROWS - 1) / TC_ROWS, num_members);
  if (scratch_bytes < (long long)grid.x * grid.y * d.block_bytes) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* w = static_cast<const unsigned char*>(tiles);
  unsigned char* buf = static_cast<unsigned char*>(scratch);
  DISPATCH(act, bf16, LAUNCH_K2WT, grid, smem, s, seed0, seed1, x, w, bs, max_lv, min_lv, out,
           dims_dev, d, buf, rows, out_size, sample)
  return cudaGetLastError();
}

int mbrl_rollout_returns_wide(unsigned int seed0, unsigned int seed1, const int* rot,
                              const float* obs0, const float* acts, const float* dmask,
                              const void* tiles, const float* bs, const float* max_lv,
                              const float* min_lv, float* out, const int* dims,
                              const int* dims_dev, int num_products, int num_members, int batch,
                              int obs_dim, int act_dim, int horizon, int out_size, int tile,
                              int sample, int act, int bf16, long long tile_elems, void* scratch,
                              long long scratch_bytes, void* stream) {
  WideDesc d;
  size_t smem;
  if (obs_dim < 1 || !make_wide_desc(bf16, dims, num_products, obs_dim + 1, &d, &smem) ||
      dims[num_products] != 2 * out_size || dims[0] != obs_dim + act_dim ||
      obs_dim != out_size - 1 || tile < 1 || tile > TC_ROWS || batch % tile != 0 ||
      d.w_member != tile_elems)
    return cudaErrorInvalidValue;
  const int num_tiles = batch / tile;
  if (num_members < 1 || num_tiles % num_members != 0) return cudaErrorInvalidValue;
  if (scratch_bytes < (long long)num_tiles * d.block_bytes) return cudaErrorInvalidValue;
  const dim3 grid(num_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* w = static_cast<const unsigned char*>(tiles);
  unsigned char* buf = static_cast<unsigned char*>(scratch);
  DISPATCH(act, bf16, LAUNCH_K1WT, grid, smem, s, seed0, seed1, rot, obs0, acts, dmask, w, bs,
           max_lv, min_lv, out, dims_dev, d, buf, obs_dim, act_dim, horizon, out_size, tile,
           num_tiles, num_tiles / num_members, sample)
  return cudaGetLastError();
}

}  // extern "C"
