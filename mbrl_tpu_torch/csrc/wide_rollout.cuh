// K1's and K2's kernels on the wide route, one template for each of their
// designs (WideMode), so that each design is compiled in its own source and
// its own nvcc: the plain one in wide_tc.cu (which holds the entries and the
// design note), the clusters in wide_cluster.cu, the resident activations in
// wide_smem.cu.
#pragma once

#include "gaussian_head.cuh"
#include "wide_tc.cuh"

// WT_PLAIN: a block per tile, each streaming its member's weights and its
// activations through the ring. WT_CLUSTER: clusters of blocks that share
// each weight chunk (produce_wide). WT_SMEM (bf16): the activations resident
// in shared memory, the ring carrying weights only (produce_wide_smem).
enum WideMode { WT_PLAIN = 0, WT_CLUSTER = 1, WT_SMEM = 2 };

// K2's arguments: x (E, S, in) f32 -> out (E, S, out_size) f32
struct K2Args {
  uint32_t seed0, seed1;
  const float* x;
  const unsigned char* ws;
  const float *bs, *max_lv, *min_lv;
  float* out;
  const int* dims;
  WideDesc d;
  unsigned char* scratch;
  int S, out_size, sample;
};

// K1's arguments: obs0 (B, obs_dim), acts (B, H, act_dim) -> out (B,)
struct K1Args {
  uint32_t seed0, seed1;
  const int* rot;
  const float *obs0, *acts, *dmask;
  const unsigned char* ws;
  const float *bs, *max_lv, *min_lv;
  float* out;
  const int* dims;
  WideDesc d;
  unsigned char* scratch;
  int obs_dim, act_dim, horizon, out_size, tile, num_tiles, tiles_per_member, sample;
};

// wide_cluster.cu: K2's and K1's kernels in clusters of `cluster` blocks
// along x, and the clusters of them the card holds at once
cudaError_t launch_k2_cluster(int act, int bf16, dim3 grid, int cluster, size_t smem,
                              cudaStream_t stream, const K2Args& a);
cudaError_t launch_k1_cluster(int act, int bf16, dim3 grid, int cluster, size_t smem,
                              cudaStream_t stream, const K1Args& a);
cudaError_t max_active_clusters(int k1, int act, int bf16, size_t smem, int cluster, int* count);
// wide_smem.cu: K2's and K1's bf16 kernels with resident activations
// (make_smem_desc's plan in a.d)
cudaError_t launch_k2_smem(int act, dim3 grid, size_t smem, cudaStream_t stream, const K2Args& a);
cudaError_t launch_k1_smem(int act, dim3 grid, size_t smem, cudaStream_t stream, const K1Args& a);

// ---------------------------------------------------------------------------
// K2: one rollout step. grid = (row tiles, E), TC_THREADS threads; in
// clusters (WT_CLUSTER) the tiles are padded to a multiple of the cluster
// along x and the blocks of a cluster run row tiles of one member and share
// its weight stream. A draw from the bounded Gaussian head, or its mean when
// sample == 0. A padded block (no rows) runs its zero tile for its share of
// the stream and writes nothing.
template <int ACT, bool BF16, int MODE>
__global__ void __launch_bounds__(TC_THREADS, 1) gaussian_wide_tc_kernel(const K2Args a) {
  constexpr bool CL = MODE == WT_CLUSTER;
  extern __shared__ __align__(128) unsigned char smem[];
  TC_STAMP(0)
  const WideDesc& d = a.d;
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * TC_ROWS;
  const int rows = min(TC_ROWS, a.S - row0);
  const int blocks = CL ? cluster_blocks() : 1;
  unsigned char* act = a.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * d.block_bytes;
  init_wide_barriers<CL>(d, smem, blocks);
  TC_STAMP(1)
  if (uniform(threadIdx.x) >= TC_CONSUMERS) {  // the producer warp
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0, ready = 0;
      const unsigned char* wm = a.ws + (size_t)e * d.w_member * TC<BF16>::ESIZE;
      if constexpr (MODE == WT_SMEM) {
        produce_wide_smem<BF16>(d, a.dims, smem, wm, it);
      } else {
        produce_wide<BF16, CL>(d, a.dims, smem, wm, act, it, ready, blocks,
                               CL ? cluster_rank() : 0);
      }
    }
    if constexpr (CL) wide_cluster_sync();  // no block leaves while a peer may reach it
    return;
  }
  const int din = __ldg(a.dims);
  const float* xe = a.x + ((size_t)e * a.S + row0) * din;
  const auto x_at = [&](int r, int c) { return r < rows ? __ldg(xe + (size_t)r * din + c) : 0.0f; };
  float* head = reinterpret_cast<float*>(act + d.head_off);
  const float* bias = a.bs + (size_t)e * d.b_member;
  uint32_t it = 0;
  if constexpr (MODE == WT_SMEM) {
    stage_smem_input<BF16>(smem + WT_BARRIER_BYTES, din, x_at);
    TC_STAMP(2)
    consume_wide_smem<ACT, BF16>(d, a.dims, smem, head, bias, it);
  } else {
    stage_wide_input<BF16>(smem, act, din, x_at);
    TC_STAMP(2)
    consume_wide<ACT, BF16, CL>(d, a.dims, smem, act, head, bias, it, blocks);
  }

  const uint2 key = make_uint2(a.seed0, a.seed1);
  const int out_size = a.out_size;
  float* o = a.out + ((size_t)e * a.S + row0) * out_size;
  for (int idx = threadIdx.x; idx < rows * out_size; idx += TC_CONSUMERS) {
    const int r = idx / out_size, c = idx - r * out_size;
    const uint4 ctr = make_uint4((uint32_t)(row0 + r), (uint32_t)c, 0u, (uint32_t)e);
    o[idx] = head_draw(head[r * d.head_ld + c], head[r * d.head_ld + out_size + c],
                       __ldg(a.max_lv + c), __ldg(a.min_lv + c), a.sample, ctr, key);
  }
  TC_STAMP(31)
  if constexpr (CL) wide_cluster_sync();
}

// ---------------------------------------------------------------------------
// K1: the whole H-step rollout. grid = (row tiles,), one block per row tile
// of `tile` (<= TC_ROWS) rows, looping over the steps inside the block; row
// tile i uses member ((i + rot[t]) % num_tiles) / tiles_per_member at step t
// (k1_member). In clusters (WT_CLUSTER) the tiles are padded to a multiple
// of the cluster; at a step where every tile of the cluster uses one member
// the cluster shares its weight stream, where they straddle two members each
// block copies its own (k1_shared), and a padded block (i >= num_tiles) runs
// a zero tile with its cluster's first tile's member and writes nothing. The
// obs carry and the running return stay in the block's scratch; per step
// only the (tile, A) action slab is read from the inputs.
__device__ __forceinline__ int k1_member(int i, int r, int num_tiles, int tiles_per_member,
                                         int first) {
  return (((i < num_tiles ? i : first) + r) % num_tiles) / tiles_per_member;
}

// whether the cluster's `blocks` tiles from `first` use one member at rotation r
__device__ __forceinline__ bool k1_shared(int first, int blocks, int r, int num_tiles,
                                          int tiles_per_member) {
  const int m = k1_member(first, r, num_tiles, tiles_per_member, first);
  bool same = true;
  for (int q = 1; q < blocks; ++q)
    same = same && k1_member(first + q, r, num_tiles, tiles_per_member, first) == m;
  return same;
}

template <int ACT, bool BF16, int MODE>
__global__ void __launch_bounds__(TC_THREADS, 1) rollout_returns_wide_tc_kernel(const K1Args a) {
  constexpr bool CL = MODE == WT_CLUSTER;
  extern __shared__ __align__(128) unsigned char smem[];
  const WideDesc& d = a.d;
  const int i = blockIdx.x;
  const int tile = a.tile, num_tiles = a.num_tiles, obs_dim = a.obs_dim;
  const int row0 = i * tile;
  const int rows = !CL || i < num_tiles ? tile : 0;
  const int blocks = CL ? cluster_blocks() : 1, rank = CL ? cluster_rank() : 0;
  const int first = i - rank;  // the cluster's first tile, always a real one
  unsigned char* act = a.scratch + (size_t)i * d.block_bytes;
  init_wide_barriers<CL>(d, smem, blocks);
  if (uniform(threadIdx.x) >= TC_CONSUMERS) {  // the producer warp
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0, ready = 0;
      for (int t = 0; t < a.horizon; ++t) {
        const int r = a.rot[t];
        const int m = k1_member(i, r, num_tiles, a.tiles_per_member, first);
        const bool shared = CL && k1_shared(first, blocks, r, num_tiles, a.tiles_per_member);
        const unsigned char* wm = a.ws + (size_t)m * d.w_member * TC<BF16>::ESIZE;
        if constexpr (MODE == WT_SMEM) {
          produce_wide_smem<BF16>(d, a.dims, smem, wm, it);
        } else {
          produce_wide<BF16, CL>(d, a.dims, smem, wm, act, it, ready, shared ? blocks : 1, rank);
        }
      }
    }
    if constexpr (CL) wide_cluster_sync();  // no block leaves while a peer may reach it
    return;
  }
  float* head = reinterpret_cast<float*>(act + d.head_off);
  float* obs = reinterpret_cast<float*>(act + d.carry_off);  // (TC_ROWS, obs_dim)
  float* total = obs + TC_ROWS * obs_dim;                    // (TC_ROWS,)
  const int din = obs_dim + a.act_dim, out_size = a.out_size, horizon = a.horizon;
  const uint2 key = make_uint2(a.seed0, a.seed1);
  for (int idx = threadIdx.x; idx < rows * obs_dim; idx += TC_CONSUMERS)
    obs[idx] = a.obs0[(size_t)row0 * obs_dim + idx];
  for (int r = threadIdx.x; r < TC_ROWS; r += TC_CONSUMERS) total[r] = 0.0f;
  consumer_sync();

  uint32_t it = 0;
  for (int t = 0; t < horizon; ++t) {
    const int m = k1_member(i, a.rot[t], num_tiles, a.tiles_per_member, first);
    // x = concat(obs, act_t), zero past the tile
    const auto x_at = [&](int r, int c) {
      if (r >= rows) return 0.0f;
      return c < obs_dim ? obs[r * obs_dim + c]
                         : __ldg(a.acts + ((size_t)(row0 + r) * horizon + t) * a.act_dim +
                                 (c - obs_dim));
    };
    const float* bias = a.bs + (size_t)m * d.b_member;
    if constexpr (MODE == WT_SMEM) {
      stage_smem_input<BF16>(smem + WT_BARRIER_BYTES, din, x_at);
      consume_wide_smem<ACT, BF16>(d, a.dims, smem, head, bias, it);
    } else {
      stage_wide_input<BF16>(smem, act, din, x_at);
      consume_wide<ACT, BF16, CL>(d, a.dims, smem, act, head, bias, it, blocks);
    }
    // one thread per (row, output column): the last column is the learned
    // reward, the others are delta (dmask = 1) or absolute next-obs targets
    for (int idx = threadIdx.x; idx < rows * out_size; idx += TC_CONSUMERS) {
      const int r = idx / out_size, c = idx - r * out_size;
      const uint4 ctr = make_uint4((uint32_t)(row0 + r), (uint32_t)c, (uint32_t)t, (uint32_t)i);
      const float pred = head_draw(head[r * d.head_ld + c], head[r * d.head_ld + out_size + c],
                                   __ldg(a.max_lv + c), __ldg(a.min_lv + c), a.sample, ctr, key);
      if (c < out_size - 1) {
        const float dm = __ldg(a.dmask + c);
        obs[r * obs_dim + c] = dm * (obs[r * obs_dim + c] + pred) + (1.0f - dm) * pred;
      } else {
        total[r] += pred;
      }
    }
    consumer_sync();  // the carry is whole before the next step reads it
  }
  for (int r = threadIdx.x; r < rows; r += TC_CONSUMERS) a.out[row0 + r] = total[r];
  if constexpr (CL) wide_cluster_sync();
}
