// The wide route of the three kernels K1, K2 and K3 (sm_90a), written by hand.
//
// Replaces the same Pallas TPU kernels of mbrl_tpu/ops/pallas_kernels.py as the
// tensor-core chain (tc_chain.cu, ensemble_mlp.cu), for the stacks the chain
// does not take:
//   K1 rollout_returns_wide_kernel <- fused_rollout_returns / _rollout_kernel
//   K2 gaussian_wide_kernel        <- fused_ensemble_mlp_gaussian / _gaussian_kernel
//   K3 ensemble_mlp_wide_kernel    <- fused_ensemble_mlp / _kernel
// The wrappers in ops/kernels.py launch this route, through the same entry
// points' siblings and with the same grid and launch count, whenever the chain
// as it stands does not fit (kernels.takes_chain): a layer wider than 256
// columns, more than MAX_PRODUCTS products, or, in K1, no room for two weight
// chunks beside the obs carry. Widest layer it takes: any (a row of the
// activation scratch holds the widest layer of the chain); deepest chain: any.
//
// What bounds it: operations, on the CUDA cores. A 64-row tile costs
// 64 x sum(d_in x d_out) fused multiply-adds in f32 (67 TFLOP/s on an H100,
// against 495 for tf32 and 989 for bf16 on the tensor cores), with every
// member's weights read from L2.
//
// Design: right first, simple; its speed is later work.
// - Same grid as the chain: K1 one block per row tile, K2 one per (64-row
//   tile, member), K3 the persistent grid of ops/kernels.py:persistent_blocks.
//   256 threads, no producer warp, 25 KB of static shared memory.
// - A tile's activations live in a scratch region of the block's own in
//   device memory, two buffers of 64 x ld f32 (ld = the widest layer), layer
//   input and output in turn; at the main shapes it stays in L2. K1 keeps its
//   obs carry and running return there too. The wrapper allocates the scratch
//   (ops/kernels.py:WideLayout) and the kernel allocates nothing.
// - The chain's descriptor comes through device memory: the dims array
//   (num_products + 1 ints); a product's weight and bias offsets are running
//   sums, so nothing bounds the depth.
// - Products: N in passes of WIDE_N = 128 columns; K in chunks of WIDE_K = 32
//   rows. A chunk of the input (64 x 32) and of the weights (32 x 128) land in
//   shared memory, and each thread sums an 8-row x 4-column block of the
//   pass's outputs in registers by f32 FMA. The weights are the MLPStack's
//   own (row-major (d_in, d_out) per product, f32 or bf16), not the chain's
//   packed tiles.
// - Rounding: a bf16 stack rounds the input and every hidden activation to
//   bf16 where the chain does (when they are written to the scratch), with
//   bf16 weights and f32 sums; an f32 stack multiplies in plain f32 (no TF32),
//   so it differs from the plain versions by summation order only.
// - Epilogues as the chain's: K3 the raw head, K2 the bounded log-variance and
//   the Gaussian sample with the same Philox counters (gaussian_head.cuh), K1
//   the obs carry and the running return.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() after its launch.

#include <limits.h>

#include "common.cuh"
#include "gaussian_head.cuh"

#define WIDE_ROWS 64      // rows of one tile (the chain's TC_ROWS)
#define WIDE_THREADS 256  // 8 warps: warp w sums rows 8w..8w+7, lane l columns 4l..4l+3
#define WIDE_N 128        // output columns of one pass
#define WIDE_K 32         // K rows of one chunk

struct WideSmem {
  float a[WIDE_K][WIDE_ROWS + 4];  // input chunk, K-major (+4: 16-byte rows, fewer conflicts)
  float w[WIDE_K][WIDE_N + 4];     // weight chunk
};

// element i of a product's weights, f32 or bf16
template <bool BF16>
__device__ __forceinline__ float load_w(const unsigned char* w, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(w) + i)));
  } else {
    return __ldg(reinterpret_cast<const float*>(w) + i);
  }
}

// The tile's rows of x (rows x din, row-major) into buf (64 x ld), zero past
// `rows`; bf16 stacks round them to bf16. The caller syncs before the chain.
template <bool BF16>
__device__ __forceinline__ void stage_input(float* buf, int ld, const float* __restrict__ x,
                                            int din, int rows) {
  for (int idx = threadIdx.x; idx < WIDE_ROWS * din; idx += WIDE_THREADS) {
    const int r = idx / din, c = idx - r * din;
    float v = r < rows ? __ldg(x + (size_t)r * din + c) : 0.0f;
    buf[(size_t)r * ld + c] = BF16 ? round_bf16(v) : v;
  }
}

// Runs the chain of the member whose weights start at `wm` and biases at `bm`
// on the tile in `buf` (64 x dims[0] at row stride ld, staged by the caller
// before a __syncthreads). Hidden layers alternate between buf and
// buf + 64 * ld; returns the buffer that holds the head (64 x
// dims[num_products], bias added, no activation). Ends with a __syncthreads.
template <int ACT, bool BF16>
__device__ float* wide_chain(const int* __restrict__ dims, int num_products,
                             const unsigned char* wm, const float* __restrict__ bm, float* buf,
                             int ld, WideSmem& sm) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float* src = buf;
  float* dst = buf + (size_t)WIDE_ROWS * ld;
  size_t w_off = 0;
  int b_off = 0;
  for (int i = 0; i < num_products; ++i) {
    const int K = __ldg(dims + i), N = __ldg(dims + i + 1);
    const bool hidden = i + 1 < num_products;
    for (int n0 = 0; n0 < N; n0 += WIDE_N) {
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += WIDE_K) {
        __syncthreads();  // every thread is done with the previous chunk
        for (int idx = threadIdx.x; idx < WIDE_ROWS * WIDE_K; idx += WIDE_THREADS) {
          const int r = idx / WIDE_K, k = idx % WIDE_K;
          sm.a[k][r] = k0 + k < K ? src[(size_t)r * ld + k0 + k] : 0.0f;
        }
        for (int idx = threadIdx.x; idx < WIDE_K * WIDE_N; idx += WIDE_THREADS) {
          const int k = idx / WIDE_N, n = idx % WIDE_N;
          sm.w[k][n] = k0 + k < K && n0 + n < N
                           ? load_w<BF16>(wm, w_off + (size_t)(k0 + k) * N + n0 + n)
                           : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < WIDE_K; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[k][8 * ty]);
          const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[k][8 * ty + 4]);
          const float4 b = *reinterpret_cast<const float4*>(&sm.w[k][4 * tx]);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
        }
      }
      // epilogue: bias, then (hidden layers) the activation and bf16 rounding
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 4 * tx + j;
        if (c < N) {
          const float bias = __ldg(bm + b_off + c);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            float v = acc[r][j] + bias;
            if (hidden) {
              v = activate<ACT>(v);
              if (BF16) v = round_bf16(v);
            }
            dst[(size_t)(8 * ty + r) * ld + c] = v;
          }
        }
      }
    }
    __syncthreads();  // the output is whole before it is read as the next input
    w_off += (size_t)K * N;
    b_off += N;
    float* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// ---------------------------------------------------------------------------
// K3: grid = (blocks,), persistent over the member-major (member, tile) list
// as ensemble_mlp_tc_kernel. x (E, S, in) f32 -> out (E, S, head_out) f32.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(WIDE_THREADS)
ensemble_mlp_wide_kernel(const float* __restrict__ x, const unsigned char* __restrict__ ws,
                         const float* __restrict__ bs, float* __restrict__ out,
                         const int* __restrict__ dims, int num_products, long long w_member,
                         int b_member, float* scratch, int ld, long long block_floats, int S,
                         int num_tiles, int total) {
  __shared__ __align__(16) WideSmem sm;
  float* buf = scratch + (size_t)blockIdx.x * block_floats;
  const int din = __ldg(dims), dh = __ldg(dims + num_products);
  constexpr int ESIZE = BF16 ? 2 : 4;
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    const int e = w / num_tiles;
    const int row0 = (w - e * num_tiles) * WIDE_ROWS;
    const int rows = min(WIDE_ROWS, S - row0);
    stage_input<BF16>(buf, ld, x + ((size_t)e * S + row0) * din, din, rows);
    __syncthreads();
    const float* head = wide_chain<ACT, BF16>(dims, num_products,
                                              ws + (size_t)e * w_member * ESIZE,
                                              bs + (size_t)e * b_member, buf, ld, sm);
    float* o = out + ((size_t)e * S + row0) * dh;
    for (int idx = threadIdx.x; idx < rows * dh; idx += WIDE_THREADS) {
      const int r = idx / dh, c = idx - r * dh;
      o[idx] = head[(size_t)r * ld + c];
    }
    __syncthreads();  // the head has been read: the next input may overwrite it
  }
}

// ---------------------------------------------------------------------------
// K2: grid = (ceil(S / 64), E). x (E, S, in) f32 -> out (E, S, out_size) f32:
// a draw from the bounded Gaussian head, or its mean when sample == 0.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(WIDE_THREADS)
gaussian_wide_kernel(uint32_t seed0, uint32_t seed1, const float* __restrict__ x,
                     const unsigned char* __restrict__ ws, const float* __restrict__ bs,
                     const float* __restrict__ max_lv, const float* __restrict__ min_lv,
                     float* __restrict__ out, const int* __restrict__ dims, int num_products,
                     long long w_member, int b_member, float* scratch, int ld,
                     long long block_floats, int S, int out_size, int sample) {
  __shared__ __align__(16) WideSmem sm;
  constexpr int ESIZE = BF16 ? 2 : 4;
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * WIDE_ROWS;
  const int rows = min(WIDE_ROWS, S - row0);
  float* buf = scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * block_floats;
  const int din = __ldg(dims);
  stage_input<BF16>(buf, ld, x + ((size_t)e * S + row0) * din, din, rows);
  __syncthreads();
  const float* head = wide_chain<ACT, BF16>(dims, num_products,
                                            ws + (size_t)e * w_member * ESIZE,
                                            bs + (size_t)e * b_member, buf, ld, sm);
  const uint2 key = make_uint2(seed0, seed1);
  float* o = out + ((size_t)e * S + row0) * out_size;
  for (int idx = threadIdx.x; idx < rows * out_size; idx += WIDE_THREADS) {
    const int r = idx / out_size, c = idx - r * out_size;
    const uint4 ctr = make_uint4((uint32_t)(row0 + r), (uint32_t)c, 0u, (uint32_t)e);
    o[idx] = head_draw(head[(size_t)r * ld + c], head[(size_t)r * ld + out_size + c],
                       __ldg(max_lv + c), __ldg(min_lv + c), sample, ctr, key);
  }
}

// ---------------------------------------------------------------------------
// K1: the whole H-step rollout, grid = (num_tiles,), one block per row tile
// of `tile` (<= 64) rows looping over the steps, with the member schedule of
// rollout_returns_tc_kernel. The obs carry (64 x obs_dim) and the running
// return (64) follow the two activation buffers in the block's scratch.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(WIDE_THREADS)
rollout_returns_wide_kernel(uint32_t seed0, uint32_t seed1, const int* __restrict__ rot,
                            const float* __restrict__ obs0, const float* __restrict__ acts,
                            const float* __restrict__ dmask, const unsigned char* __restrict__ ws,
                            const float* __restrict__ bs, const float* __restrict__ max_lv,
                            const float* __restrict__ min_lv, float* __restrict__ out,
                            const int* __restrict__ dims, int num_products, long long w_member,
                            int b_member, float* scratch, int ld, long long block_floats,
                            int obs_dim, int act_dim, int horizon, int out_size, int tile,
                            int num_tiles, int tiles_per_member, int sample) {
  __shared__ __align__(16) WideSmem sm;
  constexpr int ESIZE = BF16 ? 2 : 4;
  const int i = blockIdx.x;
  const int row0 = i * tile;
  float* buf = scratch + (size_t)i * block_floats;
  float* obs = buf + 2 * (size_t)WIDE_ROWS * ld;
  float* total = obs + (size_t)WIDE_ROWS * obs_dim;
  const int din = obs_dim + act_dim;
  const uint2 key = make_uint2(seed0, seed1);
  for (int idx = threadIdx.x; idx < tile * obs_dim; idx += WIDE_THREADS)
    obs[idx] = obs0[(size_t)row0 * obs_dim + idx];
  for (int r = threadIdx.x; r < WIDE_ROWS; r += WIDE_THREADS) total[r] = 0.0f;
  __syncthreads();
  for (int t = 0; t < horizon; ++t) {
    const int m = ((i + rot[t]) % num_tiles) / tiles_per_member;
    // x = concat(obs, act_t), zero past the tile
    for (int idx = threadIdx.x; idx < WIDE_ROWS * din; idx += WIDE_THREADS) {
      const int r = idx / din, c = idx - r * din;
      float v = 0.0f;
      if (r < tile) {
        v = c < obs_dim ? obs[r * obs_dim + c]
                        : acts[((size_t)(row0 + r) * horizon + t) * act_dim + (c - obs_dim)];
      }
      buf[(size_t)r * ld + c] = BF16 ? round_bf16(v) : v;
    }
    __syncthreads();
    const float* head = wide_chain<ACT, BF16>(dims, num_products,
                                              ws + (size_t)m * w_member * ESIZE,
                                              bs + (size_t)m * b_member, buf, ld, sm);
    // one thread per (row, output column): the last column is the learned
    // reward, the others are delta (dmask = 1) or absolute next-obs targets
    for (int idx = threadIdx.x; idx < tile * out_size; idx += WIDE_THREADS) {
      const int r = idx / out_size, c = idx - r * out_size;
      const uint4 ctr = make_uint4((uint32_t)(row0 + r), (uint32_t)c, (uint32_t)t, (uint32_t)i);
      const float pred = head_draw(head[(size_t)r * ld + c], head[(size_t)r * ld + out_size + c],
                                   __ldg(max_lv + c), __ldg(min_lv + c), sample, ctr, key);
      if (c < out_size - 1) {
        const float dm = dmask[c];
        obs[r * obs_dim + c] = dm * (obs[r * obs_dim + c] + pred) + (1.0f - dm) * pred;
      } else {
        total[r] += pred;
      }
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < tile; r += WIDE_THREADS) out[row0 + r] = total[r];
}

// ---------------------------------------------------------------------------
// Host side

// A stack's sizes from its host dims: weight elements and biases per member
// and the widest layer (the scratch's row stride); false if a width is < 1.
static bool wide_sizes(const int* dims, int num_products, long long* w_member, int* b_member,
                       int* ld) {
  if (num_products < 1) return false;
  long long w = 0, b = 0;
  int widest = 0;
  for (int i = 0; i <= num_products; ++i) {
    if (dims[i] < 1) return false;
    widest = widest > dims[i] ? widest : dims[i];
  }
  for (int i = 0; i < num_products; ++i) {
    w += (long long)dims[i] * dims[i + 1];
    b += dims[i + 1];
  }
  if (b > INT_MAX || (long long)WIDE_ROWS * widest > INT_MAX) return false;
  *w_member = w;
  *b_member = (int)b;
  *ld = widest;
  return true;
}

#define LAUNCH_WIDE(KERNEL, ACT, BF16, grid, stream, ...) \
  KERNEL<ACT, BF16><<<grid, WIDE_THREADS, 0, stream>>>(__VA_ARGS__);
#define LAUNCH_K3W(ACT, BF16, grid, stream, ...) \
  LAUNCH_WIDE(ensemble_mlp_wide_kernel, ACT, BF16, grid, stream, __VA_ARGS__)
#define LAUNCH_K2W(ACT, BF16, grid, stream, ...) \
  LAUNCH_WIDE(gaussian_wide_kernel, ACT, BF16, grid, stream, __VA_ARGS__)
#define LAUNCH_K1W(ACT, BF16, grid, stream, ...) \
  LAUNCH_WIDE(rollout_returns_wide_kernel, ACT, BF16, grid, stream, __VA_ARGS__)

extern "C" {

// Every entry takes the stack's dims twice: `dims` on the host (checked here,
// sizes the scratch) and `dims_dev`, the same ints in device memory (read by
// the kernel); `ws` is the MLPStack's weight tensor with `w_elems` elements
// per member; `scratch` holds `scratch_floats` f32, at least grid blocks x
// the block's share (ops/kernels.py:WideLayout).
int mbrl_ensemble_mlp_wide(const float* x, const void* ws, const float* bs, float* out,
                           const int* dims, const int* dims_dev, int num_products,
                           int num_members, int rows, int blocks, int act, int bf16,
                           long long w_elems, float* scratch, long long scratch_floats,
                           void* stream) {
  long long w_member;
  int b_member, ld;
  if (!wide_sizes(dims, num_products, &w_member, &b_member, &ld) || rows < 1 ||
      num_members < 1 || w_member != w_elems)
    return cudaErrorInvalidValue;
  const int num_tiles = (rows + WIDE_ROWS - 1) / WIDE_ROWS;
  const long long total = (long long)num_tiles * num_members;
  const long long block_floats = 2LL * WIDE_ROWS * ld;
  if (blocks < 1 || blocks > total || total > INT_MAX || scratch_floats < blocks * block_floats)
    return cudaErrorInvalidValue;
  const dim3 grid(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* w = static_cast<const unsigned char*>(ws);
  DISPATCH(act, bf16, LAUNCH_K3W, grid, s, x, w, bs, out, dims_dev, num_products, w_member,
           b_member, scratch, ld, block_floats, rows, num_tiles, (int)total)
  return cudaGetLastError();
}

int mbrl_ensemble_mlp_gaussian_wide(unsigned int seed0, unsigned int seed1, const float* x,
                                    const void* ws, const float* bs, const float* max_lv,
                                    const float* min_lv, float* out, const int* dims,
                                    const int* dims_dev, int num_products, int num_members,
                                    int rows, int out_size, int sample, int act, int bf16,
                                    long long w_elems, float* scratch, long long scratch_floats,
                                    void* stream) {
  long long w_member;
  int b_member, ld;
  if (!wide_sizes(dims, num_products, &w_member, &b_member, &ld) || rows < 1 ||
      num_members < 1 || dims[num_products] != 2 * out_size || w_member != w_elems)
    return cudaErrorInvalidValue;
  const dim3 grid((rows + WIDE_ROWS - 1) / WIDE_ROWS, num_members);
  const long long block_floats = 2LL * WIDE_ROWS * ld;
  if (scratch_floats < (long long)grid.x * grid.y * block_floats) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* w = static_cast<const unsigned char*>(ws);
  DISPATCH(act, bf16, LAUNCH_K2W, grid, s, seed0, seed1, x, w, bs, max_lv, min_lv, out, dims_dev,
           num_products, w_member, b_member, scratch, ld, block_floats, rows, out_size, sample)
  return cudaGetLastError();
}

int mbrl_rollout_returns_wide(unsigned int seed0, unsigned int seed1, const int* rot,
                              const float* obs0, const float* acts, const float* dmask,
                              const void* ws, const float* bs, const float* max_lv,
                              const float* min_lv, float* out, const int* dims,
                              const int* dims_dev, int num_products, int num_members, int batch,
                              int obs_dim, int act_dim, int horizon, int out_size, int tile,
                              int sample, int act, int bf16, long long w_elems, float* scratch,
                              long long scratch_floats, void* stream) {
  long long w_member;
  int b_member, ld;
  if (!wide_sizes(dims, num_products, &w_member, &b_member, &ld) ||
      dims[num_products] != 2 * out_size || dims[0] != obs_dim + act_dim ||
      obs_dim != out_size - 1 || tile < 1 || tile > WIDE_ROWS || batch % tile != 0 ||
      w_member != w_elems)
    return cudaErrorInvalidValue;
  const int num_tiles = batch / tile;
  if (num_members < 1 || num_tiles % num_members != 0) return cudaErrorInvalidValue;
  const long long block_floats = 2LL * WIDE_ROWS * ld + (long long)WIDE_ROWS * (obs_dim + 1);
  if (scratch_floats < (long long)num_tiles * block_floats) return cudaErrorInvalidValue;
  const dim3 grid(num_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* w = static_cast<const unsigned char*>(ws);
  DISPATCH(act, bf16, LAUNCH_K1W, grid, s, seed0, seed1, rot, obs0, acts, dmask, w, bs, max_lv,
           min_lv, out, dims_dev, num_products, w_member, b_member, scratch, ld, block_floats,
           obs_dim, act_dim, horizon, out_size, tile, num_tiles, num_tiles / num_members, sample)
  return cudaGetLastError();
}

}  // extern "C"
