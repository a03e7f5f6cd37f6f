// The equal-shard ensemble forward K3 on Hopper's tensor cores (sm_90a),
// written by hand.
//
// Replaces the Pallas TPU kernel fused_ensemble_mlp / _kernel of
// mbrl_tpu/ops/pallas_kernels.py (member m runs its own MLP chain over its own
// contiguous shard of rows; the head comes out raw). It is the step of
// ModelEnv.step -> GaussianMLP._forward_sharded, at anything from a planner's
// 8,000 rows to a policy-training rollout's 100,000, and the per-step rollout
// of a deterministic head.
//
// What bounds it: operations. A row costs 131,800 MACs at the PETS widths
// against 23 input and 36 output floats, and a member's weights (264 KB bf16,
// 2 x 527 KB as tf32 hi/lo pairs) are read from L2, not device memory, after
// the first tile.
//
// Design.
// - The products are K2's: produce_chain() on the producer warpgroup's first
//   thread (its other warps idle: K3 draws no normals) and
//   consume_chain() on two consumer warpgroups (tc_chain.cuh; the design notes
//   are at the top of tc_chain.cu): weights pre-packed by pack_chain in
//   wgmma's layout, landed by 1-D bulk copies through the mbarrier ring, bf16
//   m64nNk16 or 3xTF32 m64nNk8 products with f32 accumulators, epilogues in
//   registers. bf16 stacks round the input and every hidden activation to
//   bf16, where the TPU kernel rounds them.
// - Persistent blocks. The work is the member-major list of (member, 64-row
//   tile) pairs. The grid is min(pairs, SMs) blocks (one block fills an SM's
//   shared memory), and block b walks pairs b, b + blocks, ..., so the
//   blocks' shares differ by at most one tile whatever E is (ops/kernels.py:
//   persistent_blocks and block_tiles mirror the schedule). The barriers are
//   set up once; the ring's chunk counter runs on across tiles on both sides,
//   so while the consumers write a head out and stage the next input tile the
//   producer is already landing the next tile's first chunks. At one wave
//   (8,000 rows: 125 pairs) this is one tile a block.
// - The raw-head epilogue: consume_chain leaves the head's (64, n_pad) f32
//   tile (a narrow head: two partial tiles, added by head_at) at the start
//   of the A region; the consumers copy its first head_out columns of the
//   tile's real rows to out, which is contiguous for a tile, so the stores
//   coalesce. The A region is also the next tile's input, hence
//   the consumer barrier between the copy and the next staging.
// - Every loop bound of the tile loop is block-uniform (blockIdx, gridDim and
//   kernel arguments), on the producer's side and the consumers' alike: both
//   count the same chunks, and ptxas sees no divergent path around the wgmma.
//
// Plain C interface, loaded with ctypes; the entry returns cudaGetLastError()
// after its launch.

#include <limits.h>

#include "tc_chain.cuh"

#ifdef TC_TIMELINE
// Marks of block 0: 0 start, 1 barriers set up; then, of the last tile it
// ran, 29 tile begun, 2 input staged, consume_chain's 3.., 30 head written out.
extern "C" int mbrl_timeline_k3(unsigned long long* out) {
  static const unsigned long long zero[96] = {};
  const cudaError_t err = cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(tc_timeline, zero, sizeof(zero));
}
#endif

// grid = (blocks,), TC_CHAIN_THREADS threads. x (E, S, in) f32 -> out (E, S,
// head_out) f32, raw head; `ws` is pack_chain()'s tiles.
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
// Host side

#define LAUNCH_K3(ACT, BF16, grid, smem, stream, ...)                                      \
  {                                                                                        \
    cudaError_t err = prepare_once<ensemble_mlp_tc_kernel<ACT, BF16>>();                   \
    if (err != cudaSuccess) return err;                                                    \
    ensemble_mlp_tc_kernel<ACT, BF16><<<grid, TC_CHAIN_THREADS, smem, stream>>>(__VA_ARGS__);    \
  }

extern "C" {

// `tiles` is pack_chain()'s weight tensor; `tile_elems` its elements per
// member, checked against this side's layout. `blocks` is the grid
// (persistent_blocks() in ops/kernels.py).
int mbrl_ensemble_mlp(const float* x, const void* tiles, const float* bs, float* out,
                      const int* dims, int num_products, int num_members, int rows, int blocks,
                      int act, int bf16, long long tile_elems, void* stream) {
  ChainDesc d;
  size_t smem;
  if (!make_chain_desc(bf16, dims, num_products, 0, &d, &smem) || rows < 1 ||
      num_members < 1 || d.w_member != tile_elems)
    return cudaErrorInvalidValue;
  const int num_tiles = (rows + TC_ROWS - 1) / TC_ROWS;
  const long long total = (long long)num_tiles * num_members;
  if (blocks < 1 || blocks > total || total > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* ws = static_cast<const unsigned char*>(tiles);
  DISPATCH(act, bf16, LAUNCH_K3, grid, smem, s, x, ws, bs, out, d, rows, num_tiles, (int)total)
  return cudaGetLastError();
}

}  // extern "C"
