// The wide route of the equal-shard ensemble forward K3 on Hopper's tensor
// cores (sm_90a), written by hand: the entry mbrl_ensemble_mlp_wide and the
// scratch route's kernel ensemble_mlp_wide_tc_kernel.
//
// Replaces the Pallas TPU kernel fused_ensemble_mlp / _kernel of
// mbrl_tpu/ops/pallas_kernels.py (member m runs its own MLP chain over its own
// contiguous shard of rows; the head comes out raw), as the chain's K3
// (ensemble_mlp.cu) does, for every stack the chain does not take
// (kernels.takes_chain: a layer wider than 256 columns, more than
// MAX_PRODUCTS products, or no room for the chain's ring). Two routes, picked
// by shape (ops/kernels.py: WideTileLayout.k3_resident mirrors the choice,
// the entry checks the route it is given): where make_wide_smem_desc's plan
// fits (every padded layer at most 512 columns) the resident route,
// ensemble_mlp_wide_smem_kernel (ensemble_mlp_wide_smem.cu: a tile's
// activations in shared memory, one pass a product); for any wider stack the
// scratch route below, which takes any width and depth. It is the step of
// ModelEnv.step -> GaussianMLP._forward_sharded and of the
// deterministic-head rollout for a wide model, at anything from a planner's
// 8,000 rows to a policy-training rollout's 100,000.
//
// What bounds it: operations, the products at the tensor peak (bf16 989
// TFLOP/s; an f32 stack as 3xTF32, three tf32 products at 495). At 4 x 512 a
// row costs 816,640 MACs against 23-24 input and 36 output floats, and a
// member's stack (1.6 MB bf16, 6.5 MB as tf32 hi/lo pairs) is read from L2
// by every tile.
//
// The scratch route's design: K1's and K2's wide products (wide_tc.cuh)
// under the chain K3's persistent tile loop (ensemble_mlp.cu).
// - produce_wide() on the producer warp and consume_wide() on two consumer
//   warpgroups: weights pre-packed by pack_wide (WideTileLayout) in wgmma's
//   layout, landed by bulk copies through the mbarrier ring beside the
//   activation chunk they multiply; passes of up to 256 output columns; bf16
//   m64nNk16 or 3xTF32 m64nNk8 products with f32 accumulators. bf16 stacks
//   round the input and every hidden activation to bf16, where the TPU kernel
//   rounds them.
// - Activations live in the block's scratch in device memory (the wrapper
//   allocates blocks x WideTileLayout.block_bytes()): two buffers in the A
//   layout, the product's input and output in turn, and the head's
//   (64, head_ld) f32.
// - Persistent blocks: the work is the member-major list of (member, 64-row
//   tile) pairs; the grid is min(pairs, SMs) blocks (one block fills an SM's
//   shared memory), and block b walks pairs b, b + blocks, ...
//   (ops/kernels.py: persistent_blocks and block_tiles mirror the schedule).
//   The barriers are set up once; the ring's counter `it` and the ready
//   barrier's phases run on across tiles on both sides, so while the
//   consumers copy a head out and stage the next tile the producer is
//   already landing that tile's first weight chunks (it waits on the ready
//   barrier only before the tile's first activation chunk).
// - Scratch reuse across tiles. The next tile's input goes into buffer 0
//   only after consume_wide returned, and every consumer thread waited there
//   on every full barrier of the tile: every bulk copy that read buffer 0 has
//   landed. The head region is written only by a tile's last epilogue, which
//   follows the next tile's staging and the consumer barrier after the copy-out.
// - The raw-head epilogue: the consumers copy the head's first head_out
//   columns of the tile's real rows to out, which is contiguous for a tile,
//   so the stores coalesce; the ragged last tile is masked on input (zero
//   rows) and output.
// - Every loop bound is block-uniform (blockIdx, gridDim, kernel arguments,
//   and the dims through uniform()), on the producer's side and the
//   consumers' alike: both count the same chunks and phases, and ptxas sees
//   no divergent path around the wgmma.
//
// Plain C interface, loaded with ctypes; the entry returns cudaGetLastError()
// after its launch.

#include "wide_tc.cuh"

#define K3W_SCRATCH 0  // the entry's routes, in the order of kernels.K3_WIDE_ROUTES
#define K3W_SMEM 1

#ifdef TC_TIMELINE
// Marks of block 0: 0 start, 1 barriers set up; then, of the last tile it
// ran, 29 tile begun, 2 input staged, produce_wide's and consume_wide's per
// product (wide_tc.cuh), 30 head written out.
extern "C" int mbrl_timeline_k3_wide(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
}
#endif

// grid = (blocks,), TC_THREADS threads. x (E, S, in) f32 -> out (E, S,
// head_out) f32, raw head; `ws` is pack_wide()'s tiles, `dims` the stack's
// dims in device memory.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(TC_THREADS, 1)
ensemble_mlp_wide_tc_kernel(const float* __restrict__ x, const unsigned char* __restrict__ ws,
                            const float* __restrict__ bs, float* __restrict__ out,
                            const int* __restrict__ dims, const WideDesc d,
                            unsigned char* scratch, int S, int num_tiles, int total) {
  extern __shared__ __align__(128) unsigned char smem[];
  TC_STAMP(0)
  unsigned char* act = scratch + (size_t)blockIdx.x * d.block_bytes;
  init_wide_barriers(d, smem);
  TC_STAMP(1)
  if (uniform(threadIdx.x) >= TC_CONSUMERS) {  // the producer warp
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0, ready = 0;
      for (int w = blockIdx.x; w < total; w += gridDim.x)
        produce_wide<BF16>(d, dims, smem, ws + (size_t)(w / num_tiles) * d.w_member * TC<BF16>::ESIZE,
                           act, it, ready);
    }
    return;
  }
  const int din = __ldg(dims), dh = __ldg(dims + d.num_products);
  float* head = reinterpret_cast<float*>(act + d.head_off);
  uint32_t it = 0;
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    TC_STAMP(29)
    const int e = w / num_tiles;
    const int row0 = (w - e * num_tiles) * TC_ROWS;
    const int rows = min(TC_ROWS, S - row0);
    // the input tile as the first product's A operand, zero past the ragged
    // last tile's rows and past `in`
    const float* xe = x + ((size_t)e * S + row0) * din;
    stage_wide_input<BF16>(smem, act, din, [&](int r, int c) {
      return r < rows ? __ldg(xe + (size_t)r * din + c) : 0.0f;
    });
    TC_STAMP(2)
    consume_wide<ACT, BF16>(d, dims, smem, act, head, bs + (size_t)e * d.b_member, it);
    float* o = out + ((size_t)e * S + row0) * dh;
    for (int idx = threadIdx.x; idx < rows * dh; idx += TC_CONSUMERS) {
      const int r = idx / dh, c = idx - r * dh;
      o[idx] = head[r * d.head_ld + c];
    }
    consumer_sync();  // the head has been read before the next tile starts
    TC_STAMP(30)
  }
}

// ---------------------------------------------------------------------------
// Host side

#define LAUNCH_K3WT(ACT, BF16, grid, smem, stream, ...)                                     \
  {                                                                                         \
    cudaError_t err = prepare_once<ensemble_mlp_wide_tc_kernel<ACT, BF16>>();               \
    if (err != cudaSuccess) return err;                                                     \
    ensemble_mlp_wide_tc_kernel<ACT, BF16><<<grid, TC_THREADS, smem, stream>>>(__VA_ARGS__); \
  }

extern "C" {

// Takes the stack's dims twice: `dims` on the host (checked here, sizes the
// layout and the scratch) and `dims_dev`, the same ints in device memory (read
// by the kernel). `tiles` is pack_wide()'s weight tensor with `tile_elems`
// elements per member, checked against this side's layout; `blocks` is the
// grid (persistent_blocks() in ops/kernels.py). `route` is K3W_SCRATCH or
// K3W_SMEM (kernels.K3_WIDE_ROUTES), refused where its plan does not take the
// stack. The scratch route's `scratch` holds `scratch_bytes`, at least blocks
// x block_bytes (ops/kernels.py:WideTileLayout.block_bytes); the resident
// route takes none.
int mbrl_ensemble_mlp_wide(const float* x, const void* tiles, const float* bs, float* out,
                           const int* dims, const int* dims_dev, int num_products,
                           int num_members, int rows, int blocks, int act, int bf16,
                           long long tile_elems, void* scratch, long long scratch_bytes, int route,
                           void* stream) {
  WideDesc d;
  size_t smem;
  const bool planned = route == K3W_SMEM ? make_wide_smem_desc(bf16, dims, num_products, &d, &smem)
                       : route == K3W_SCRATCH && make_wide_desc(bf16, dims, num_products, 0, &d, &smem);
  if (!planned || rows < 1 || num_members < 1 || d.w_member != tile_elems)
    return cudaErrorInvalidValue;
  const int num_tiles = (rows + TC_ROWS - 1) / TC_ROWS;
  const long long total = (long long)num_tiles * num_members;
  if (blocks < 1 || blocks > total || total > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* w = static_cast<const unsigned char*>(tiles);
  if (route == K3W_SMEM) {
    const K3Args a{x, w, bs, out, dims_dev, d, rows, num_tiles, (int)total, act};
    const cudaError_t err = launch_k3_wide_smem(bf16, grid, smem, s, a);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  if (scratch_bytes < (long long)blocks * d.block_bytes) return cudaErrorInvalidValue;
  unsigned char* buf = static_cast<unsigned char*>(scratch);
  DISPATCH(act, bf16, LAUNCH_K3WT, grid, smem, s, x, w, bs, out, dims_dev, d, buf, rows,
           num_tiles, (int)total)
  return cudaGetLastError();
}

}  // extern "C"
