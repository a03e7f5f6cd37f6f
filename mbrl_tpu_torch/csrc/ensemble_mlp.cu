// Ensemble-MLP rollout kernels for Hopper (sm_90a), written by hand.
//
// Replaces the three Pallas TPU kernels of mbrl_tpu/ops/pallas_kernels.py:
//   K1 rollout_returns_kernel   <- fused_rollout_returns / _rollout_kernel
//                                  (whole H-step imagined rollout, one launch)
//   K2 gaussian_kernel          <- fused_ensemble_mlp_gaussian / _gaussian_kernel
//                                  (one rollout step: MLP chain + bounded
//                                  Gaussian head + Box-Muller sample)
//   K3 ensemble_mlp_kernel      <- fused_ensemble_mlp / _kernel
//                                  (equal-shard ensemble forward, raw head)
// All three share one device routine, mlp_chain(), for the member's layer chain.
//
// What bounds them on this card: the work is a chain of small dependent
// products (rows x 200 x 200 per layer), 2 * 131,800 FLOP per row-step at the
// PETS shape, against ~2.6 MB of elite weights per launch -- far above the
// H100's FP32 ridge point, so all three are compute-bound.
//
// The Hopper design problem. The TPU kernels pin a member's whole weight stack
// in VMEM (K1 pins all five elites, ~2.6 MB). One member's f32 stack at the
// PETS shape is 23*200 + 3*200^2 + 200*36 = 131,800 floats (~527 KB): it does
// not fit in the 227 KB of shared memory a block can use, and even bf16
// (~264 KB) does not. This first design therefore streams each layer's
// weights through shared memory in K-chunks of K_CHUNK rows, straight from L2
// (the 2.6 MB elite stack sits easily in the 50 MB L2). The activation tile
// (TILE_ROWS rows) lives in two shared-memory buffers, ping-ponged between
// layers, so inter-layer activations never touch device memory. Products
// accumulate in f32 with FMA on the CUDA cores (no TF32, which would change
// the numbers). A bf16 weight stack is widened to f32 as it is staged; the
// activations are rounded to bf16 before each product, at the same points as
// the TPU kernels, so the bf16 numbers match the reference.
//
// Simple and correct first; a later redesign (a thread-block cluster
// splitting a member's stack across SMs, or wgmma on streamed tiles) has to
// solve the weight residency problem to approach the tensor-core bound.
//
// Sampling: counter-based Philox4x32-10, keyed on two 32-bit seed words from
// the host wrapper, counting on (row, column, step/tile, program). 24-bit
// uniforms and Box-Muller exactly as pallas_kernels.py:201-207 and :367-373.
//
// Plain C interface, loaded with ctypes. Every entry returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PRODUCTS 9   // up to 8 hidden layers + the head
#define MAX_WIDTH 256    // widest layer input/output the register tile covers
#define TILE_ROWS 64     // rows of one block's activation tile
#define THREADS 256
#define ROW_GROUPS 16                         // threads along rows
#define COL_GROUPS (THREADS / ROW_GROUPS)     // threads along columns (16)
#define ROWS_PER_THREAD (TILE_ROWS / ROW_GROUPS)   // 4
#define COLS_PER_THREAD (MAX_WIDTH / COL_GROUPS)   // 16
#define K_CHUNK 16       // weight rows staged per shared-memory chunk

enum Activation {
  ACT_RELU = 0,
  ACT_SILU = 1,
  ACT_TANH = 2,
  ACT_ELU = 3,
  ACT_GELU = 4,
  ACT_LEAKY_RELU = 5,
};

struct MLPDesc {
  int num_products;               // hidden layers + head
  int dims[MAX_PRODUCTS + 1];     // dims[0] = input, dims[num_products] = head out
  long long w_off[MAX_PRODUCTS];  // element offset of product i's (d_in, d_out) block
  int b_off[MAX_PRODUCTS];
  long long w_member;             // weight elements per member
  int b_member;                   // bias elements per member
  int ld;                         // row stride of the activation buffers (floats)
  int wld_max;                    // widest staged weight row (floats)
};

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == ACT_RELU) {
    return fmaxf(x, 0.0f);
  } else if constexpr (ACT == ACT_SILU) {
    return x / (1.0f + expf(-x));
  } else if constexpr (ACT == ACT_TANH) {
    return tanhf(x);
  } else if constexpr (ACT == ACT_ELU) {
    return x > 0.0f ? x : expm1f(x);
  } else if constexpr (ACT == ACT_GELU) {
    // jax.nn.gelu's default: the tanh approximation
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
  } else {
    return x >= 0.0f ? x : 0.01f * x;  // leaky_relu, slope 0.01
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float load_weight(const void* w, long long idx) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[idx]);
  } else {
    return static_cast<const float*>(w)[idx];
  }
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// logvar soft double-bounding (reference gaussian_mlp.py:150-154)
__device__ __forceinline__ float bound_logvar(float lv, float max_lv, float min_lv) {
  lv = max_lv - softplus(max_lv - lv);
  return min_lv + softplus(lv - min_lv);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// standard normal from one Philox block: 24-bit uniforms, u1 in (0, 1]
// (log-safe), u2 in [0, 1), Box-Muller cosine branch
__device__ __forceinline__ float box_muller(uint4 bits) {
  const float u1 = (static_cast<float>(bits.x >> 8) + 1.0f) * 5.9604644775390625e-08f;
  const float u2 = static_cast<float>(bits.y >> 8) * 5.9604644775390625e-08f;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// out[r, n] = f(sum_k in[r, k] * w[k, n] + b[n]) for the block's TILE_ROWS rows.
// `in`/`out` are shared-memory tiles with row stride d.ld; `w` is the member's
// (din, dout) block in device memory, staged through `wbuf` K_CHUNK rows at a
// time. Thread (rg, cg) owns rows rg + ROW_GROUPS*r and columns
// cg + COL_GROUPS*j. Ends with a barrier: `out` is complete on return.
template <int ACT, bool BF16>
__device__ void dense(const float* in, float* out, float* wbuf, const void* w,
                      const float* b, int din, int dout, int ld, bool hidden) {
  const int tid = threadIdx.x;
  const int cg = tid % COL_GROUPS;
  const int rg = tid / COL_GROUPS;
  const int nj = (dout + COL_GROUPS - 1) / COL_GROUPS;
  const int wld = nj * COL_GROUPS;  // staged row width, zero-padded past dout

  float acc[ROWS_PER_THREAD][COLS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r)
#pragma unroll
    for (int j = 0; j < COLS_PER_THREAD; ++j) acc[r][j] = 0.0f;

  for (int k0 = 0; k0 < din; k0 += K_CHUNK) {
    const int kc = min(K_CHUNK, din - k0);
    __syncthreads();  // the previous chunk has been consumed
    for (int idx = tid; idx < kc * wld; idx += THREADS) {
      const int kk = idx / wld;
      const int n = idx - kk * wld;
      wbuf[idx] = n < dout ? load_weight<BF16>(w, (long long)(k0 + kk) * dout + n) : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float a[ROWS_PER_THREAD];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r)
        a[r] = in[(rg + ROW_GROUPS * r) * ld + k0 + kk];
      const float* wrow = wbuf + kk * wld + cg;
#pragma unroll
      for (int j = 0; j < COLS_PER_THREAD; ++j) {
        if (j < nj) {
          const float wv = wrow[COL_GROUPS * j];
#pragma unroll
          for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r][j] = fmaf(a[r], wv, acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < COLS_PER_THREAD; ++j) {
    const int n = cg + COL_GROUPS * j;
    if (j < nj && n < dout) {
      const float bn = b[n];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        float v = acc[r][j] + bn;
        if (hidden) {
          v = activate<ACT>(v);
          if (BF16) v = round_bf16(v);  // bf16 operand of the next product
        }
        out[(rg + ROW_GROUPS * r) * ld + n] = v;
      }
    }
  }
  __syncthreads();
}

// The member's whole chain: hidden layers then the raw head. The input tile
// is in buf0 (already bf16-rounded for a bf16 stack). Returns the buffer that
// holds the head output.
template <int ACT, bool BF16>
__device__ float* mlp_chain(float* buf0, float* buf1, float* wbuf, const MLPDesc& d,
                            const void* ws, const float* bs, int member) {
  const size_t wsize = BF16 ? sizeof(__nv_bfloat16) : sizeof(float);
  const char* wm = static_cast<const char*>(ws) + (size_t)member * d.w_member * wsize;
  const float* bm = bs + (size_t)member * d.b_member;
  float* cur = buf0;
  float* nxt = buf1;
  for (int i = 0; i < d.num_products; ++i) {
    dense<ACT, BF16>(cur, nxt, wbuf, wm + (size_t)d.w_off[i] * wsize, bm + d.b_off[i],
                     d.dims[i], d.dims[i + 1], d.ld, i + 1 < d.num_products);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Loads rows [row0, row0 + rows) of a row-major (., din) matrix into the tile,
// zero-filling the rows past `rows`.
template <bool BF16>
__device__ void load_tile(float* tile, const float* x, int rows, int din, int ld) {
  for (int idx = threadIdx.x; idx < TILE_ROWS * din; idx += THREADS) {
    const int r = idx / din;
    const int c = idx - r * din;
    float v = r < rows ? x[(size_t)r * din + c] : 0.0f;
    if (BF16) v = round_bf16(v);
    tile[r * ld + c] = v;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K3: equal-shard ensemble forward. grid = (ceil(S / TILE_ROWS), E).
// x (E, S, in) f32 -> out (E, S, head_out) f32, raw head.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(THREADS)
ensemble_mlp_kernel(const float* __restrict__ x, const void* __restrict__ ws,
                    const float* __restrict__ bs, float* __restrict__ out, MLPDesc d, int S) {
  extern __shared__ float smem[];
  float* buf0 = smem;
  float* buf1 = buf0 + TILE_ROWS * d.ld;
  float* wbuf = buf1 + TILE_ROWS * d.ld;
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * TILE_ROWS;
  const int rows = min(TILE_ROWS, S - row0);
  const int din = d.dims[0];
  const int dh = d.dims[d.num_products];
  load_tile<BF16>(buf0, x + ((size_t)e * S + row0) * din, rows, din, d.ld);
  const float* res = mlp_chain<ACT, BF16>(buf0, buf1, wbuf, d, ws, bs, e);
  float* o = out + ((size_t)e * S + row0) * dh;
  for (int idx = threadIdx.x; idx < rows * dh; idx += THREADS) {
    const int r = idx / dh;
    const int c = idx - r * dh;
    o[idx] = res[r * d.ld + c];
  }
}

// ---------------------------------------------------------------------------
// K2: one rollout step. grid = (ceil(S / TILE_ROWS), E).
// x (E, S, in) f32 -> out (E, S, out_size) f32: a draw from the bounded
// Gaussian head, or its mean when sample == 0.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(THREADS)
gaussian_kernel(uint32_t seed0, uint32_t seed1, const float* __restrict__ x,
                const void* __restrict__ ws, const float* __restrict__ bs,
                const float* __restrict__ max_lv, const float* __restrict__ min_lv,
                float* __restrict__ out, MLPDesc d, int S, int out_size, int sample) {
  extern __shared__ float smem[];
  float* buf0 = smem;
  float* buf1 = buf0 + TILE_ROWS * d.ld;
  float* wbuf = buf1 + TILE_ROWS * d.ld;
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * TILE_ROWS;
  const int rows = min(TILE_ROWS, S - row0);
  const int din = d.dims[0];
  load_tile<BF16>(buf0, x + ((size_t)e * S + row0) * din, rows, din, d.ld);
  const float* res = mlp_chain<ACT, BF16>(buf0, buf1, wbuf, d, ws, bs, e);
  float* o = out + ((size_t)e * S + row0) * out_size;
  const uint2 key = make_uint2(seed0, seed1);
  for (int idx = threadIdx.x; idx < rows * out_size; idx += THREADS) {
    const int r = idx / out_size;
    const int c = idx - r * out_size;
    const float mean = res[r * d.ld + c];
    float pred = mean;
    if (sample) {
      const float lv = bound_logvar(res[r * d.ld + out_size + c], max_lv[c], min_lv[c]);
      const uint4 ctr = make_uint4((uint32_t)(row0 + r), (uint32_t)c, 0u, (uint32_t)e);
      pred = mean + expf(0.5f * lv) * box_muller(philox4x32_10(ctr, key));
    }
    o[idx] = pred;
  }
}

// ---------------------------------------------------------------------------
// K1: the whole H-step rollout. grid = (num_tiles,), one block per row tile of
// `tile` (<= TILE_ROWS) rows, looping over the steps inside the block. The obs
// carry and the running total stay in shared memory for all H steps; per step
// only the (tile, A) action slab is read from device memory. Row tile i uses
// member ((i + rot[t]) % num_tiles) / tiles_per_member at step t.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(THREADS)
rollout_returns_kernel(uint32_t seed0, uint32_t seed1, const int* __restrict__ rot,
                       const float* __restrict__ obs0, const float* __restrict__ acts,
                       const float* __restrict__ dmask, const void* __restrict__ ws,
                       const float* __restrict__ bs, const float* __restrict__ max_lv,
                       const float* __restrict__ min_lv, float* __restrict__ out, MLPDesc d,
                       int obs_dim, int act_dim, int horizon, int out_size, int tile,
                       int num_tiles, int tiles_per_member, int sample) {
  extern __shared__ float smem[];
  float* buf0 = smem;
  float* buf1 = buf0 + TILE_ROWS * d.ld;
  float* wbuf = buf1 + TILE_ROWS * d.ld;
  float* obs = wbuf + K_CHUNK * d.wld_max;  // (TILE_ROWS, obs_dim) carry
  float* total = obs + TILE_ROWS * obs_dim;  // (TILE_ROWS,) running return
  const int i = blockIdx.x;
  const int row0 = i * tile;
  const int din = obs_dim + act_dim;
  const uint2 key = make_uint2(seed0, seed1);

  for (int idx = threadIdx.x; idx < tile * obs_dim; idx += THREADS)
    obs[idx] = obs0[(size_t)row0 * obs_dim + idx];
  for (int r = threadIdx.x; r < TILE_ROWS; r += THREADS) total[r] = 0.0f;
  __syncthreads();

  for (int t = 0; t < horizon; ++t) {
    const int m = ((i + rot[t]) % num_tiles) / tiles_per_member;
    // x = concat(obs, act_t), rounded to bf16 for a bf16 stack
    for (int idx = threadIdx.x; idx < TILE_ROWS * din; idx += THREADS) {
      const int r = idx / din;
      const int c = idx - r * din;
      float v = 0.0f;
      if (r < tile) {
        v = c < obs_dim ? obs[r * obs_dim + c]
                        : acts[((size_t)(row0 + r) * horizon + t) * act_dim + (c - obs_dim)];
      }
      if (BF16) v = round_bf16(v);
      buf0[r * d.ld + c] = v;
    }
    __syncthreads();
    const float* res = mlp_chain<ACT, BF16>(buf0, buf1, wbuf, d, ws, bs, m);
    // one thread per (row, output column): the last column is the learned
    // reward, the others are delta (dmask = 1) or absolute next-obs targets
    for (int idx = threadIdx.x; idx < tile * out_size; idx += THREADS) {
      const int r = idx / out_size;
      const int c = idx - r * out_size;
      const float mean = res[r * d.ld + c];
      float pred = mean;
      if (sample) {
        const float lv = bound_logvar(res[r * d.ld + out_size + c], max_lv[c], min_lv[c]);
        const uint4 ctr =
            make_uint4((uint32_t)(row0 + r), (uint32_t)c, (uint32_t)t, (uint32_t)i);
        pred = mean + expf(0.5f * lv) * box_muller(philox4x32_10(ctr, key));
      }
      if (c < out_size - 1) {
        const float dm = dmask[c];
        obs[r * obs_dim + c] = dm * (obs[r * obs_dim + c] + pred) + (1.0f - dm) * pred;
      } else {
        total[r] += pred;
      }
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < tile; r += THREADS) out[row0 + r] = total[r];
}

// ---------------------------------------------------------------------------
// Host side

static bool make_desc(const int* dims, int num_products, MLPDesc* d) {
  if (num_products < 1 || num_products > MAX_PRODUCTS) return false;
  d->num_products = num_products;
  long long w = 0;
  int b = 0;
  int maxw = 0;
  for (int i = 0; i <= num_products; ++i) {
    if (dims[i] < 1 || dims[i] > MAX_WIDTH) return false;
    d->dims[i] = dims[i];
    maxw = dims[i] > maxw ? dims[i] : maxw;
  }
  for (int i = 0; i < num_products; ++i) {
    d->w_off[i] = w;
    d->b_off[i] = b;
    w += (long long)dims[i] * dims[i + 1];
    b += dims[i + 1];
  }
  d->w_member = w;
  d->b_member = b;
  d->ld = maxw + 4;  // pad: rows rg and rg + 1 fall in different banks
  d->wld_max = (maxw + COL_GROUPS - 1) / COL_GROUPS * COL_GROUPS;
  return true;
}

static size_t chain_smem_bytes(const MLPDesc& d) {
  return sizeof(float) * ((size_t)2 * TILE_ROWS * d.ld + (size_t)K_CHUNK * d.wld_max);
}

template <typename Kernel>
static cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

#define DISPATCH_ACT(act, BF16, KERNEL, ...)                                  \
  switch (act) {                                                            \
    case ACT_RELU: KERNEL(ACT_RELU, BF16, __VA_ARGS__); break;              \
    case ACT_SILU: KERNEL(ACT_SILU, BF16, __VA_ARGS__); break;              \
    case ACT_TANH: KERNEL(ACT_TANH, BF16, __VA_ARGS__); break;              \
    case ACT_ELU: KERNEL(ACT_ELU, BF16, __VA_ARGS__); break;                \
    case ACT_GELU: KERNEL(ACT_GELU, BF16, __VA_ARGS__); break;              \
    case ACT_LEAKY_RELU: KERNEL(ACT_LEAKY_RELU, BF16, __VA_ARGS__); break;  \
    default: return cudaErrorInvalidValue;                                  \
  }

#define DISPATCH(act, bf16, KERNEL, ...)               \
  if (bf16) {                                          \
    DISPATCH_ACT(act, true, KERNEL, __VA_ARGS__)       \
  } else {                                             \
    DISPATCH_ACT(act, false, KERNEL, __VA_ARGS__)      \
  }

#define LAUNCH_K3(ACT, BF16, grid, smem, stream, ...)                                  \
  {                                                                                    \
    cudaError_t err = prepare(ensemble_mlp_kernel<ACT, BF16>, smem);                   \
    if (err != cudaSuccess) return err;                                                \
    ensemble_mlp_kernel<ACT, BF16><<<grid, THREADS, smem, stream>>>(__VA_ARGS__);      \
  }

#define LAUNCH_K2(ACT, BF16, grid, smem, stream, ...)                                  \
  {                                                                                    \
    cudaError_t err = prepare(gaussian_kernel<ACT, BF16>, smem);                       \
    if (err != cudaSuccess) return err;                                                \
    gaussian_kernel<ACT, BF16><<<grid, THREADS, smem, stream>>>(__VA_ARGS__);          \
  }

#define LAUNCH_K1(ACT, BF16, grid, smem, stream, ...)                                  \
  {                                                                                    \
    cudaError_t err = prepare(rollout_returns_kernel<ACT, BF16>, smem);                \
    if (err != cudaSuccess) return err;                                                \
    rollout_returns_kernel<ACT, BF16><<<grid, THREADS, smem, stream>>>(__VA_ARGS__);   \
  }

extern "C" {

int mbrl_ensemble_mlp(const float* x, const void* ws, const float* bs, float* out,
                      const int* dims, int num_products, int num_members, int rows, int act,
                      int bf16, void* stream) {
  MLPDesc d;
  if (!make_desc(dims, num_products, &d) || rows < 1 || num_members < 1)
    return cudaErrorInvalidValue;
  const size_t smem = chain_smem_bytes(d);
  const dim3 grid((rows + TILE_ROWS - 1) / TILE_ROWS, num_members);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(act, bf16, LAUNCH_K3, grid, smem, s, x, ws, bs, out, d, rows)
  return cudaGetLastError();
}

int mbrl_ensemble_mlp_gaussian(unsigned int seed0, unsigned int seed1, const float* x,
                               const void* ws, const float* bs, const float* max_lv,
                               const float* min_lv, float* out, const int* dims,
                               int num_products, int num_members, int rows, int out_size,
                               int sample, int act, int bf16, void* stream) {
  MLPDesc d;
  if (!make_desc(dims, num_products, &d) || rows < 1 || num_members < 1 ||
      d.dims[num_products] != 2 * out_size)
    return cudaErrorInvalidValue;
  const size_t smem = chain_smem_bytes(d);
  const dim3 grid((rows + TILE_ROWS - 1) / TILE_ROWS, num_members);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(act, bf16, LAUNCH_K2, grid, smem, s, seed0, seed1, x, ws, bs, max_lv, min_lv, out,
           d, rows, out_size, sample)
  return cudaGetLastError();
}

int mbrl_rollout_returns(unsigned int seed0, unsigned int seed1, const int* rot,
                         const float* obs0, const float* acts, const float* dmask,
                         const void* ws, const float* bs, const float* max_lv,
                         const float* min_lv, float* out, const int* dims, int num_products,
                         int num_members, int batch, int obs_dim, int act_dim, int horizon,
                         int out_size, int tile, int sample, int act, int bf16, void* stream) {
  MLPDesc d;
  if (!make_desc(dims, num_products, &d) || d.dims[num_products] != 2 * out_size ||
      d.dims[0] != obs_dim + act_dim || obs_dim != out_size - 1 || tile < 1 ||
      tile > TILE_ROWS || batch % tile != 0)
    return cudaErrorInvalidValue;
  const int num_tiles = batch / tile;
  if (num_tiles % num_members != 0) return cudaErrorInvalidValue;
  const int tiles_per_member = num_tiles / num_members;
  const size_t smem =
      chain_smem_bytes(d) + sizeof(float) * ((size_t)TILE_ROWS * obs_dim + TILE_ROWS);
  const dim3 grid(num_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH(act, bf16, LAUNCH_K1, grid, smem, s, seed0, seed1, rot, obs0, acts, dmask, ws, bs,
           max_lv, min_lv, out, d, obs_dim, act_dim, horizon, out_size, tile, num_tiles,
           tiles_per_member, sample)
  return cudaGetLastError();
}

}  // extern "C"
