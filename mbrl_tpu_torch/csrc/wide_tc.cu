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
// - K2 one block per (64-row tile, member), K1 one block per row tile looping
//   over the steps; one launch a wrapper call. 288 threads: two consumer
//   warpgroups and one producer warp. The kernels (wide_rollout.cuh) are one
//   template of three designs (WideMode), each compiled in its own source:
//   the plain ring here, the resident activations in wide_smem.cu, the
//   clusters in wide_cluster.cu. The entries pick the design by shape
//   (mirrored in ops/kernels.py): clusters when asked for, else resident
//   activations for a bf16 stack whose buffers fit (make_smem_desc: up to
//   512 columns), else the plain ring.
// - Products on wgmma: bf16 m64nNk16 for a bf16 stack; 3xTF32 on m64nNk8 for
//   an f32 stack (a_hi w_hi + a_hi w_lo + a_lo w_hi), so f32-grade results.
// - Each product runs in passes of up to WT_PASS = 256 output columns, one
//   half per warpgroup with its 64 accumulators in registers, over K chunks of
//   16 (f32) or 64 (bf16) rows.
// - Weights are packed once per model state (ops/kernels.py:pack_wide,
//   WideTileLayout; mirrored by make_wide_desc): per product, per pass, per K
//   chunk, in wgmma's unswizzled K-major B layout, zero-padded, f32 as tf32 hi
//   and lo copies.
// - The plain ring: activations live in a per-block scratch in device memory
//   (the wrapper allocates it): two buffers, the product's input and output
//   in turn, each already in the layout an A chunk lands in (a_index, chunk
//   after chunk, hi then lo). The epilogue applies bias, activation and bf16
//   rounding and writes the next product's A operand there; the head goes
//   there as f32. One producer thread keeps a ring of up to TC_MAX_STAGES
//   buffers in flight, each one bulk copy of a weight chunk and one of the
//   activation chunk beside it (cp.async.bulk + mbarrier complete_tx), so
//   loads overlap the products of the chunks before. Between products the
//   activations make a round trip through device memory: the consumers'
//   stores are generic-proxy writes, so every consumer thread fences them
//   (fence.proxy.async.global) and arrives on a ready barrier that the
//   producer waits on before it copies the product's first activation chunk;
//   that chunk's weights are already in flight.
// - Resident activations (bf16): a 64-row tile's two activation buffers
//   (64 KB each at 512 columns) stay in shared memory beside a ring of three
//   32 KB weight chunks. The epilogue writes the next product's A operand
//   there, fenced for the async proxy and handed on by a consumer barrier; the
//   producer streams weights only and never waits for activations, so the
//   next product's first chunks are in the ring when its epilogue ends
//   (PERF.md, section 6: K2 and K1 10-14% faster than the plain ring in bf16
//   at config B's and A's shapes on an H100 80GB HBM3, 700 W).
// - Clusters (on request, kernels.WIDE_CLUSTER): 2 blocks of one
//   member along x, the tiles padded to a multiple of the cluster, launched
//   with cudaLaunchKernelEx. Each weight chunk is fetched once: block
//   `it % 2` issues it as one multicast bulk copy into both blocks' ring
//   buffers and full barriers (produce_wide); each block still lands its own
//   activation chunk, so every full barrier expects what it did before. A
//   buffer is refilled only when every consumer warp of the cluster has
//   released it: each arrives on every block's empty barrier (mapa, remote
//   mbarrier.arrive). A cluster barrier ends the kernel, so no block leaves
//   while a peer can still copy into it or arrive on it. K1's tiles of a
//   cluster straddle two members at a step now and then (the rotation): at
//   such a step each block copies its own weights, chosen from rot[t] alike
//   in both blocks and on both sides, so the ring counters and barrier
//   phases run in step. It halves the weight bytes read from L2, but on the
//   same H100 the ring's period did not fall (f32 at config B's shape, a
//   40 KB buffer every 0.74 us in pairs against 0.64 alone): L2's reads do
//   not pace the ring, and the coupled blocks were slower than the plain ring
//   in f32 and than the resident activations in bf16 (PERF.md, section 6).
//   The wrappers take one block a cluster.
// - Control flow stays warp-uniform (the dims come from device memory through
//   __shfl_sync), so ptxas keeps the wgmma pipelined. The arguments come in
//   one struct (K2Args, K1Args): the K2 kernels, which spilled registers with
//   separate parameters, compile without spills.
// - Heads as the chain's: the bounded log-variance and the Gaussian draw with
//   the same Philox counters (gaussian_head.cuh): (row, column, 0, member) in
//   K2, (row, column, step, tile) in K1, so a draw is the same function of the
//   seed on every route and design. K1's obs carry and running return live in
//   the scratch. Every design sums in the same order: for one seed their
//   outputs are equal bit for bit.
//
// Plain C interface, loaded with ctypes. Every entry returns
// cudaGetLastError() after its launch.

#include "wide_rollout.cuh"

#ifdef TC_TIMELINE
// Marks of K2's block (0, 0) (and of K1's block 0, where K1 ran last): 0
// start, 1 barriers set up, 2 input staged, produce_wide's and consume_wide's
// per product (wide_tc.cuh), 31 sampled.
extern "C" int mbrl_timeline_wide(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
}
#endif

// ---------------------------------------------------------------------------
// Host side

#define LAUNCH_K2WT(ACT, BF16, grid, smem, stream, args)                                  \
  {                                                                                        \
    cudaError_t err = prepare_once<gaussian_wide_tc_kernel<ACT, BF16, WT_PLAIN>>();        \
    if (err != cudaSuccess) return err;                                                    \
    gaussian_wide_tc_kernel<ACT, BF16, WT_PLAIN><<<grid, TC_THREADS, smem, stream>>>(args); \
  }

#define LAUNCH_K1WT(ACT, BF16, grid, smem, stream, args)                                         \
  {                                                                                               \
    cudaError_t err = prepare_once<rollout_returns_wide_tc_kernel<ACT, BF16, WT_PLAIN>>();        \
    if (err != cudaSuccess) return err;                                                           \
    rollout_returns_wide_tc_kernel<ACT, BF16, WT_PLAIN><<<grid, TC_THREADS, smem, stream>>>(args); \
  }

// clusters of 4 (28 x 5 blocks at config B's shape) need a second wave: the card holds 30
static bool valid_cluster(int cluster) { return cluster == 1 || cluster == 2; }

extern "C" {

// Both entries take the stack's dims twice: `dims` on the host (checked here,
// sizes the layout and the scratch) and `dims_dev`, the same ints in device
// memory (read by the kernel). `tiles` is pack_wide()'s weight tensor with
// `tile_elems` elements per member, checked against this side's layout;
// `cluster` is the blocks of a cluster (1 or 2; kernels.WIDE_CLUSTERS), the
// grid's x the row tiles padded to a multiple of it (kernels.wide_grid);
// `scratch` holds `scratch_bytes`, at least the grid's blocks x block_bytes
// (ops/kernels.py:WideTileLayout.block_bytes).
int mbrl_ensemble_mlp_gaussian_wide(unsigned int seed0, unsigned int seed1, const float* x,
                                    const void* tiles, const float* bs, const float* max_lv,
                                    const float* min_lv, float* out, const int* dims,
                                    const int* dims_dev, int num_products, int num_members,
                                    int rows, int out_size, int sample, int act, int bf16,
                                    long long tile_elems, int cluster, void* scratch,
                                    long long scratch_bytes, void* stream) {
  WideDesc d;
  size_t smem;
  if (!make_wide_desc(bf16, dims, num_products, 0, &d, &smem) || rows < 1 || num_members < 1 ||
      dims[num_products] != 2 * out_size || d.w_member != tile_elems || !valid_cluster(cluster))
    return cudaErrorInvalidValue;
  const int tiles_x = (rows + TC_ROWS - 1) / TC_ROWS;
  const dim3 grid((tiles_x + cluster - 1) / cluster * cluster, num_members);
  if (scratch_bytes < (long long)grid.x * grid.y * d.block_bytes) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const K2Args a = {seed0, seed1, x, static_cast<const unsigned char*>(tiles), bs, max_lv, min_lv,
                    out, dims_dev, d, static_cast<unsigned char*>(scratch), rows, out_size, sample};
  WideDesc resident;
  size_t smem_resident;
  cudaError_t err = cudaSuccess;
  if (cluster > 1) {
    err = launch_k2_cluster(act, bf16, grid, cluster, smem, s, a);
  } else if (bf16 && make_smem_desc(dims, num_products, 0, &resident, &smem_resident)) {
    K2Args ar = a;
    ar.d = resident;
    err = launch_k2_smem(act, grid, smem_resident, s, ar);
  } else {
    DISPATCH(act, bf16, LAUNCH_K2WT, grid, smem, s, a)
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int mbrl_rollout_returns_wide(unsigned int seed0, unsigned int seed1, const int* rot,
                              const float* obs0, const float* acts, const float* dmask,
                              const void* tiles, const float* bs, const float* max_lv,
                              const float* min_lv, float* out, const int* dims,
                              const int* dims_dev, int num_products, int num_members, int batch,
                              int obs_dim, int act_dim, int horizon, int out_size, int tile,
                              int sample, int act, int bf16, long long tile_elems, int cluster,
                              void* scratch, long long scratch_bytes, void* stream) {
  WideDesc d;
  size_t smem;
  if (obs_dim < 1 || !make_wide_desc(bf16, dims, num_products, obs_dim + 1, &d, &smem) ||
      dims[num_products] != 2 * out_size || dims[0] != obs_dim + act_dim ||
      obs_dim != out_size - 1 || tile < 1 || tile > TC_ROWS || batch % tile != 0 ||
      d.w_member != tile_elems || !valid_cluster(cluster))
    return cudaErrorInvalidValue;
  const int num_tiles = batch / tile;
  if (num_members < 1 || num_tiles % num_members != 0) return cudaErrorInvalidValue;
  const dim3 grid((num_tiles + cluster - 1) / cluster * cluster);
  if (scratch_bytes < (long long)grid.x * d.block_bytes) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const K1Args a = {seed0, seed1, rot, obs0, acts, dmask, static_cast<const unsigned char*>(tiles),
                    bs, max_lv, min_lv, out, dims_dev, d, static_cast<unsigned char*>(scratch),
                    obs_dim, act_dim, horizon, out_size, tile, num_tiles,
                    num_tiles / num_members, sample};
  WideDesc resident;
  size_t smem_resident;
  cudaError_t err = cudaSuccess;
  if (cluster > 1) {
    err = launch_k1_cluster(act, bf16, grid, cluster, smem, s, a);
  } else if (bf16 && make_smem_desc(dims, num_products, obs_dim + 1, &resident, &smem_resident)) {
    K1Args ar = a;
    ar.d = resident;
    err = launch_k1_smem(act, grid, smem_resident, s, ar);
  } else {
    DISPATCH(act, bf16, LAUNCH_K1WT, grid, smem, s, a)
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The clusters of `cluster` blocks of K1's (k1 = 1) or K2's wide kernel for
// this stack that the card holds at once, into *count (one block fills an
// SM's shared memory: at most the SMs / cluster).
int mbrl_wide_max_active_clusters(int k1, const int* dims, int num_products, int carry_floats,
                                  int act, int bf16, int cluster, int* count) {
  WideDesc d;
  size_t smem;
  if (!make_wide_desc(bf16, dims, num_products, carry_floats, &d, &smem) ||
      !valid_cluster(cluster))
    return cudaErrorInvalidValue;
  return max_active_clusters(k1, act, bf16, smem, cluster, count);
}

}  // extern "C"
