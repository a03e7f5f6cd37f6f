// The wide route of K3 (sm_90a), written by hand: ensemble_mlp_wide_kernel
// replaces fused_ensemble_mlp / _kernel of mbrl_tpu/ops/pallas_kernels.py, as
// the tensor-core chain (ensemble_mlp.cu) does, for the stacks the chain does
// not take (kernels.takes_chain): a layer wider than 256 columns or more than
// MAX_PRODUCTS products. Widest layer it takes: any (a row of the activation
// scratch holds the widest layer of the chain); deepest chain: any. The wide
// route of K1 and K2 runs on the tensor cores (wide_tc.cu).
//
// What bounds it: operations, on the CUDA cores. A 64-row tile costs
// 64 x sum(d_in x d_out) fused multiply-adds in f32 (67 TFLOP/s on an H100,
// against 495 for tf32 and 989 for bf16 on the tensor cores), with every
// member's weights read from L2.
//
// Design: right first, simple; its speed is later work.
// - The persistent grid of ops/kernels.py:persistent_blocks, as the chain's.
//   256 threads, no producer warp, 25 KB of static shared memory.
// - A tile's activations live in a scratch region of the block's own in
//   device memory, two buffers of 64 x ld f32 (ld = the widest layer), layer
//   input and output in turn; at the main shapes it stays in L2. The wrapper
//   allocates the scratch (ops/kernels.py:WideLayout) and the kernel
//   allocates nothing.
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
//   so it differs from the plain version by summation order only.
// - The epilogue writes the raw head, as the chain's.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() after its launch.

#include <limits.h>

#include "common.cuh"

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

}  // extern "C"
