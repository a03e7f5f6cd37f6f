// Ensemble-MLP forward kernel for Hopper (sm_90a), written by hand: K3.
//
// Replaces the Pallas TPU kernel fused_ensemble_mlp / _kernel of
// mbrl_tpu/ops/pallas_kernels.py (equal-shard ensemble forward, raw head).
// K1 and K2 (the rollout kernels) run on the tensor cores in tc_chain.cu.
//
// What bounds it on this card: the work is a chain of small dependent
// products (rows x 200 x 200 per layer), 2 * 131,800 FLOP per row at the
// PETS shape, against ~2.6 MB of elite weights -- compute-bound.
//
// Design (the first, simple one; its tensor-core redesign is queued): one
// member's f32 stack at the PETS shape is 131,800 floats (~527 KB) and does
// not fit in the 227 KB of shared memory a block can use. mlp_chain()
// therefore streams each layer's weights through shared memory in K-chunks
// of K_CHUNK rows, straight from L2. The activation tile (TILE_ROWS rows)
// lives in two shared-memory buffers, ping-ponged between layers. Products
// accumulate in f32 with FMA on the CUDA cores. A bf16 weight stack is
// widened to f32 as it is staged; the activations are rounded to bf16 before
// each product, at the same points as the TPU kernel.
//
// Plain C interface, loaded with ctypes; the entry returns cudaGetLastError()
// after its launch.

#include "common.cuh"

#define MAX_WIDTH 256    // widest layer input/output the register tile covers
#define TILE_ROWS 64     // rows of one block's activation tile
#define THREADS 256
#define ROW_GROUPS 16                         // threads along rows
#define COL_GROUPS (THREADS / ROW_GROUPS)     // threads along columns (16)
#define ROWS_PER_THREAD (TILE_ROWS / ROW_GROUPS)   // 4
#define COLS_PER_THREAD (MAX_WIDTH / COL_GROUPS)   // 16
#define K_CHUNK 16       // weight rows staged per shared-memory chunk

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

template <bool BF16>
__device__ __forceinline__ float load_weight(const void* w, long long idx) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[idx]);
  } else {
    return static_cast<const float*>(w)[idx];
  }
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

#define LAUNCH_K3(ACT, BF16, grid, smem, stream, ...)                                  \
  {                                                                                    \
    cudaError_t err = prepare(ensemble_mlp_kernel<ACT, BF16>, smem);                   \
    if (err != cudaSuccess) return err;                                                \
    ensemble_mlp_kernel<ACT, BF16><<<grid, THREADS, smem, stream>>>(__VA_ARGS__);      \
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

}  // extern "C"
