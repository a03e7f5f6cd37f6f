// The rollout kernels K1 and K2 on Hopper's tensor cores (sm_90a), written by hand.
//
// Replaces two Pallas TPU kernels of mbrl_tpu/ops/pallas_kernels.py:
//   K1 rollout_returns_tc_kernel <- fused_rollout_returns / _rollout_kernel
//                                   (whole H-step imagined rollout, one launch)
//   K2 gaussian_tc_kernel        <- fused_ensemble_mlp_gaussian / _gaussian_kernel
//                                   (one rollout step: MLP chain + bounded
//                                   Gaussian head + Box-Muller sample)
// Both run the member's layer chain through one routine: produce_chain() on a
// producer warp and consume_chain() on two consumer warpgroups.
//
// What bounds them: the tensor cores and L2. At the PETS shape a 64-row tile
// needs 64 x 131,800 MACs per step, and a member's weight stack (264 KB bf16,
// 2 x 527 KB as tf32 hi/lo pairs) is larger than a block's 227 KB of shared
// memory, so every block streams its member's stack from L2 at every step.
//
// Design.
// - Weights are packed once per rollout (ops/kernels.py: pack_chain) into
//   chunks that are already in wgmma's shared-memory layout: K-major, no
//   swizzle, 8-row x 16-byte core matrices, zero padding. One 1-D bulk async
//   copy (cp.async.bulk ... mbarrier::complete_tx) lands a chunk: no tensor
//   map, no libcuda.
// - One producer warp keeps a ring of up to TC_MAX_STAGES chunk buffers in
//   flight, tracked by full/empty mbarriers, so the next chunk's copy
//   overlaps the current chunk's products; in K1 it runs ahead into the next
//   step's chunks while the consumers sample the head.
// - Two consumer warpgroups per 64-row tile, each taking half of N, issue
//   wgmma.mma_async with the activations (A) and the weight chunk (B) both in
//   shared memory and the f32 accumulators in registers. Two, not one: the
//   epilogues between dependent products run on the CUDA cores, and 8 warps
//   hide their latency better than 4. A warpgroup's N is one instruction
//   width (8..120, a compile-time case: 60 accumulator registers; N = 208 is
//   104 columns, 52 registers, per warpgroup).
// - Each chunk is one pipeline stage (fence, products, commit), straight-line
//   and on warp-uniform control flow. ptxas serializes wgmma (a wait before
//   every one) when a stage depends on a path it must treat as divergent, so
//   the role split and the warpgroup index are broadcast with __shfl_sync,
//   the barrier wait loops in PTX, arrivals are predicated, and a product's
//   first step overwrites the accumulators (scale-d = 0) instead of zeroing.
// - bf16 stacks: m64nNk16 bf16 products; the activations are rounded to bf16
//   where the TPU kernels round them (kernel input, every hidden activation).
// - f32 stacks: 3xTF32 on m64nNk8 tf32 products, a_hi*w_hi + a_hi*w_lo +
//   a_lo*w_hi with hi = rna_tf32(v) and lo = rna_tf32(v - hi), which keeps
//   f32-grade results (never plain TF32). wgmma takes tf32 operands only
//   K-major, which is the packed layout. The epilogue writes a_lo next to a_hi.
// - Epilogues run in registers: bias, then the activation, then the next
//   layer's A operand in shared memory; the head goes to shared memory (over
//   the A region, which is free by then) for the Gaussian sample.
//
// Sampling: counter-based Philox4x32-10 keyed on two seed words from the
// wrapper, counting on (row, column, 0, member) in K2 and (row, column,
// step, tile) in K1.
//
// Plain C interface, loaded with ctypes. Every entry returns
// cudaGetLastError() after its launch.

#include "common.cuh"
#include "wgmma_ops.cuh"

#define TC_ROWS 64                        // rows of one tile (one wgmma M)
#define TC_CONSUMERS 256                  // two warpgroups, each half of N
#define TC_THREADS (TC_CONSUMERS + 32)    // + one producer warp
#define TC_MAX_WIDTH 240                  // widest layer: N/2 <= 120 per warpgroup
#define TC_MAX_STAGES 4
#define TC_SMEM_LIMIT 232448              // shared memory one block can use
#define TC_BARRIER_BYTES 128              // full[s] at 8s, empty[s] at 64 + 8s
#define TC_BOUNDS_BYTES 1024              // the head's logvar bounds: 2 x 128 floats
#define ACC_REGS 60                       // f32 accumulators for N = 120

// Timeline instrumentation, compiled only with -DTC_TIMELINE (see
// scripts/torch_chain_timeline.py): warpgroup w's thread 0 of block (0, 0)
// writes %globaltimer at mark k to tc_timeline[k + 32 w]. Predicated, not
// branched, so that it leaves the wgmma pipeline as it is.
#ifdef TC_TIMELINE
__device__ unsigned long long tc_timeline[64];
#define TC_STAMP(k)                                                                   \
  {                                                                                    \
    unsigned long long now;                                                            \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));                            \
    const int on = blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x & 127) == 0;     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\n@p st.global.u64 [%0], %1;\n}\n" \
                 ::"l"(tc_timeline + (k) + 32 * (threadIdx.x >> 7)), "l"(now), "r"(on)     \
                 : "memory");                                                          \
  }
extern "C" int mbrl_timeline(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
}
#else
#define TC_STAMP(k)
#endif

// per-dtype constants: element size, elements per 16 bytes, instruction depth,
// K rows per chunk, and copies of each chunk (tf32 hi and lo)
template <bool BF16>
struct TC;
template <>
struct TC<true> {
  static constexpr int ESIZE = 2, T = 8, KSTEP = 16, CHUNK = 64, COPIES = 1;
};
template <>
struct TC<false> {
  static constexpr int ESIZE = 4, T = 4, KSTEP = 8, CHUNK = 16, COPIES = 2;
};

// Mirrors ChainLayout in ops/kernels.py.
struct ChainDesc {
  int num_products;
  int dims[MAX_PRODUCTS + 1];
  int kp[MAX_PRODUCTS];            // product i's K, padded to the instruction depth
  int np[MAX_PRODUCTS];            // its N: the next K, or the head out padded to 8
  long long w_off[MAX_PRODUCTS];   // element offset of product i in a member's tiles
  int b_off[MAX_PRODUCTS];
  long long w_member;              // tile elements per member
  int b_member;                    // bias elements per member
  int a_copy_bytes;                // one activation copy: TC_ROWS x max K
  int a_bytes;                     // activation region (hi, lo; later the head output)
  int stage_bytes;                 // one ring buffer: the largest chunk
  int stages;
  int extra_off;                   // logvar bounds, then (K1) obs carry and running total
};

// ---------------------------------------------------------------------------
// PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Waits for the barrier's phase `parity` to complete. A wait of more than 4 s
// (a lost copy) traps, so a fault ends the launch with an error instead of
// hanging the card. The loop is in PTX: a loop in C++ would be a divergent
// path to the compiler, and ptxas then serializes the wgmma after it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "TC_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra TC_DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 4000000000;\n"
      "@p trap;\n"
      "bra TC_WAIT;\n"
      "TC_DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One arrival, from the threads where `on` is true (predicated, not branched).
__device__ __forceinline__ void mbar_arrive(uint32_t bar, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::
          "r"(bar),
      "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy stores to shared memory become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier of the consumer warpgroups only (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(TC_CONSUMERS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins the accumulators after a wait: no read of them moves above it.
__device__ __forceinline__ void fence_acc(float* acc) {
#pragma unroll
  for (int j = 0; j < ACC_REGS; ++j) asm volatile("" : "+f"(acc[j])::"memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (between core matrices adjacent in K) and stride byte offset
// (between core matrices adjacent in M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// f32 -> tf32 rounded to nearest, ties away from zero: cvt.rna.tf32.f32 on
// finite values, done in integer instructions (the conversion unit is the
// busier pipe in the epilogue). The 13 low bits come out zero.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// ---------------------------------------------------------------------------
// The Gaussian head's sampler: 24-bit uniforms and Box-Muller as
// mbrl_tpu/ops/pallas_kernels.py:201-207 and :367-373

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

// One Gaussian-head output: the mean, or mean + exp(logvar / 2) * N(0, 1)
// with the normal drawn from Philox at counter `ctr`.
__device__ __forceinline__ float head_draw(float mean, float raw_lv, float max_lv, float min_lv,
                                           bool sample, uint4 ctr, uint2 key) {
  if (!sample) return mean;
  const float lv = bound_logvar(raw_lv, max_lv, min_lv);
  return mean + expf(0.5f * lv) * box_muller(philox4x32_10(ctr, key));
}

// ---------------------------------------------------------------------------
// Products

// One chunk's products for one warpgroup, straight-line: no branch between
// two wgmma, so they pipeline. STEPS k-steps of N columns, each k-step two
// core matrices deep; 3xTF32 for an f32 stack, the small cross terms first.
// `a`/`b` are the shared addresses of the chunk's first core matrices (hi
// copies; the lo copies at a_lo/b_lo); b_lbo = the product's N * 16 bytes.
template <int N, int STEPS, bool BF16>
__device__ __forceinline__ void issue_chunk(int first, float* acc, uint32_t a, uint32_t a_lo,
                                            uint32_t b, uint32_t b_lo, uint32_t b_lbo) {
#pragma unroll
  for (int q = 0; q < STEPS; ++q) {
    const uint64_t da = smem_desc(a + q * 2 * (8 * 128), 8 * 128, 128);
    const uint64_t db = smem_desc(b + q * 2 * b_lbo, b_lbo, 128);
    const int add = q > 0 || !first;  // the product's first step overwrites acc
    if constexpr (BF16) {
      wgmma_bf16<N>(acc, da, db, add);
    } else {
      const uint64_t da_lo = smem_desc(a_lo + q * 2 * (8 * 128), 8 * 128, 128);
      const uint64_t db_lo = smem_desc(b_lo + q * 2 * b_lbo, b_lbo, 128);
      wgmma_tf32<N>(acc, da_lo, db, add);
      wgmma_tf32<N>(acc, da, db_lo, 1);
      wgmma_tf32<N>(acc, da, db, 1);
    }
  }
}

// Each case is a whole pipeline stage: fence, the products, commit.
template <int STEPS, bool BF16>
__device__ __forceinline__ void issue_steps(int n8, int first, float* acc, uint32_t a,
                                            uint32_t a_lo, uint32_t b, uint32_t b_lo,
                                            uint32_t b_lbo) {
  switch (n8) {
#define TC_CASE(J)                                                         \
  case J:                                                                  \
    wgmma_fence();                                                         \
    issue_chunk<8 * J, STEPS, BF16>(first, acc, a, a_lo, b, b_lo, b_lbo);  \
    wgmma_commit();                                                        \
    break;
    TC_CASE(1) TC_CASE(2) TC_CASE(3) TC_CASE(4) TC_CASE(5) TC_CASE(6) TC_CASE(7) TC_CASE(8)
    TC_CASE(9) TC_CASE(10) TC_CASE(11) TC_CASE(12) TC_CASE(13) TC_CASE(14) TC_CASE(15)
#undef TC_CASE
    default:  // this warpgroup has no columns: an empty group keeps the count
      wgmma_commit();
  }
}

template <int S, bool BF16>
__device__ __forceinline__ void issue_upto(int steps, int n8, int first, float* acc, uint32_t a,
                                           uint32_t a_lo, uint32_t b, uint32_t b_lo,
                                           uint32_t b_lbo) {
  if constexpr (S == 1) {
    issue_steps<1, BF16>(n8, first, acc, a, a_lo, b, b_lo, b_lbo);
  } else if (steps == S) {
    issue_steps<S, BF16>(n8, first, acc, a, a_lo, b, b_lo, b_lbo);
  } else {
    issue_upto<S - 1, BF16>(steps, n8, first, acc, a, a_lo, b, b_lo, b_lbo);
  }
}

// acc += A[:, k0:k0+kc] @ W[k0:k0+kc, n0:n0+8*n8] for one chunk, kc = steps * KSTEP,
// as one commit group; `first`: the product's first chunk (acc = instead of +=)
template <bool BF16>
__device__ __forceinline__ void issue(int steps, int n8, int first, float* acc, uint32_t a,
                                      uint32_t a_lo, uint32_t b, uint32_t b_lo, uint32_t b_lbo) {
  issue_upto<TC<BF16>::CHUNK / TC<BF16>::KSTEP, BF16>(steps, n8, first, acc, a, a_lo, b, b_lo,
                                                      b_lbo);
}

// f(j, v[r][c], v[r][c+1], v[r+8][c], v[r+8][c+1], c) over this thread's
// accumulators (wgmma's D fragment: warp w of the warpgroup holds rows
// 16w..16w+15, lane l rows 16w + l/4 and +8, columns n0 + 8j + 2(l%4) and +1).
template <typename F>
__device__ __forceinline__ void for_each_acc(const float* acc, int n8, int n0, F f) {
  const int c = n0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < ACC_REGS / 4; ++j)
    if (j < n8) f(j, acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3], c + 8 * j);
}

// The activation of the hidden layers. silu (the PETS models') as
// x * rcp(1 + 2^(-x log2 e)) on the special-function unit: two approximate
// instructions (relative error near 2^-22 each) instead of expf and an IEEE
// division, which made the epilogue, not the products, the block's largest
// cost. x -> -inf gives x * rcp(inf) = -0.
template <int ACT>
__device__ __forceinline__ float tc_activate(float x) {
  if constexpr (ACT == ACT_SILU) {
    float e, r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * -1.4426950408889634f));
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
    return x * r;
  } else {
    return activate<ACT>(x);
  }
}

// element index of A[r, c] in the unswizzled K-major layout: core matrix
// (c / T, r / 8) at ((c / T) * 8 + r / 8) * 128 bytes
template <bool BF16>
__device__ __forceinline__ int a_index(int r, int c) {
  constexpr int T = TC<BF16>::T;
  return (((c / T) * 8 + (r >> 3)) * 8 + (r & 7)) * T + (c % T);
}

// A[r, c] = v as the product's operand: bf16, or the tf32 pair (hi, lo)
template <bool BF16>
__device__ __forceinline__ void store_a(unsigned char* a, int a_copy_bytes, int r, int c, float v) {
  const int idx = a_index<BF16>(r, c);
  if constexpr (BF16) {
    reinterpret_cast<__nv_bfloat16*>(a)[idx] = __float2bfloat16_rn(v);
  } else {
    const float hi = to_tf32(v);
    reinterpret_cast<float*>(a)[idx] = hi;
    reinterpret_cast<float*>(a + a_copy_bytes)[idx] = to_tf32(v - hi);
  }
}

// A[r, c:c+2] = (v0, v1), c even
template <bool BF16>
__device__ __forceinline__ void store_a2(unsigned char* a, int a_copy_bytes, int r, int c, float v0,
                                         float v1) {
  const int idx = a_index<BF16>(r, c);
  if constexpr (BF16) {
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(a) + idx) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    const float h0 = to_tf32(v0), h1 = to_tf32(v1);
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(a) + idx) = make_float2(h0, h1);
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(a + a_copy_bytes) + idx) =
        make_float2(to_tf32(v0 - h0), to_tf32(v1 - h1));
  }
}

// ---------------------------------------------------------------------------
// The chain: producer warp and consumer warpgroups. `it` counts chunks over
// the launch on both sides, so stage = it % stages and parity = it / stages.

__device__ __forceinline__ void init_barriers(const ChainDesc& d, unsigned char* smem) {
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(smem);
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                        // full: the producer's expect_tx
      mbar_init(bars + 64 + 8 * s, TC_CONSUMERS / 32);   // empty: one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Streams member `wm`'s chunks, product by product, into the ring.
template <bool BF16>
__device__ void produce_chain(const ChainDesc& d, unsigned char* smem, const unsigned char* wm,
                              uint32_t& it) {
  using C = TC<BF16>;
  const uint32_t bars = smem_u32(smem);
  const uint32_t stage0 = bars + TC_BARRIER_BYTES + d.a_bytes;
  const unsigned char* src = wm;
  for (int i = 0; i < d.num_products; ++i) {
    for (int k0 = 0; k0 < d.kp[i]; k0 += C::CHUNK) {
      const uint32_t bytes = min(C::CHUNK, d.kp[i] - k0) * d.np[i] * C::ESIZE * C::COPIES;
      const int s = it % d.stages;
      mbar_wait(bars + 64 + 8 * s, ((it / d.stages) & 1) ^ 1);
      mbar_expect_tx(bars + 8 * s, bytes);
      bulk_load(stage0 + s * d.stage_bytes, src, bytes, bars + 8 * s);
      src += bytes;
      ++it;
    }
  }
}

// Runs the member's chain on the tile in the A region (written and fenced by
// the caller). Hidden layers leave their output in A; the head leaves
// (TC_ROWS, np[last]) f32 at the start of the A region. Ends with a consumer
// barrier.
template <int ACT, bool BF16>
__device__ void consume_chain(const ChainDesc& d, unsigned char* smem, const float* bias,
                              uint32_t& it) {
  using C = TC<BF16>;
  const uint32_t bars = smem_u32(smem);
  unsigned char* a_buf = smem + TC_BARRIER_BYTES;
  const uint32_t a_addr = bars + TC_BARRIER_BYTES;
  const uint32_t stage0 = a_addr + d.a_bytes;
  const int lane = threadIdx.x & 31;
  // this warpgroup's half of N; the shuffle tells the compiler it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float acc[ACC_REGS];
  for (int i = 0; i < d.num_products; ++i) {
    const int kp = d.kp[i], np = d.np[i];
    const int half = (np / 8 + 1) / 2;  // warpgroup 0's 8-column groups
    const int n8 = wg ? np / 8 - half : half, n0 = wg ? 8 * half : 0;
    const uint32_t b_lbo = np * 16;
    // this thread's biases, loaded now so that the loads overlap the products
    const float* b = bias + d.b_off[i];
    const int dout = d.dims[i + 1];
    float bia[ACC_REGS / 2];
#pragma unroll
    for (int j = 0; j < ACC_REGS / 4; ++j) {
      const int c = n0 + 2 * (lane & 3) + 8 * j;
      bia[2 * j] = j < n8 && c < dout ? __ldg(b + c) : 0.0f;
      bia[2 * j + 1] = j < n8 && c + 1 < dout ? __ldg(b + c + 1) : 0.0f;
    }
    int prev = -1;  // the previous chunk's buffer, freed once its products are done
    for (int k0 = 0; k0 < kp; k0 += C::CHUNK) {
      const int kc = min(C::CHUNK, kp - k0);
      const int s = it % d.stages;
      mbar_wait(bars + 8 * s, (it / d.stages) & 1);
      const uint32_t st = stage0 + s * d.stage_bytes + n0 * 16;
      const uint32_t lo = kc * np * C::ESIZE;  // the lo block follows the hi block
      const uint32_t a = a_addr + (k0 / C::T) * (8 * 128);
      issue<BF16>(kc / C::KSTEP, n8, k0 == 0, acc, a, a + d.a_copy_bytes, st, st + lo, b_lbo);
      wgmma_wait<1>();  // the previous chunk's products are done: free its buffer
      if (prev >= 0) mbar_arrive(bars + 64 + 8 * prev, lane == 0);
      prev = s;
      ++it;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    TC_STAMP(3 + 3 * i)
    mbar_arrive(bars + 64 + 8 * prev, lane == 0);
    consumer_sync();  // every warp's products have read A before it is overwritten
    TC_STAMP(4 + 3 * i)
    if (i + 1 < d.num_products) {
      for_each_acc(acc, n8, n0, [&](int j, float v00, float v01, float v10, float v11, int c) {
        const bool in0 = c < dout, in1 = c + 1 < dout;
        const float b0 = bia[2 * j], b1 = bia[2 * j + 1];
        store_a2<BF16>(a_buf, d.a_copy_bytes, r, c, in0 ? tc_activate<ACT>(v00 + b0) : 0.0f,
                       in1 ? tc_activate<ACT>(v01 + b1) : 0.0f);
        store_a2<BF16>(a_buf, d.a_copy_bytes, r + 8, c, in0 ? tc_activate<ACT>(v10 + b0) : 0.0f,
                       in1 ? tc_activate<ACT>(v11 + b1) : 0.0f);
      });
      fence_proxy_async();
    } else {
      float* head = reinterpret_cast<float*>(a_buf);
      for_each_acc(acc, n8, n0, [&](int j, float v00, float v01, float v10, float v11, int c) {
        const float b0 = bia[2 * j], b1 = bia[2 * j + 1];
        *reinterpret_cast<float2*>(head + r * np + c) = make_float2(v00 + b0, v01 + b1);
        *reinterpret_cast<float2*>(head + (r + 8) * np + c) = make_float2(v10 + b0, v11 + b1);
      });
    }
    consumer_sync();
    TC_STAMP(5 + 3 * i)
  }
}

// ---------------------------------------------------------------------------
// K2: one rollout step. grid = (ceil(S / TC_ROWS), E), TC_THREADS threads.
// x (E, S, in) f32 -> out (E, S, out_size) f32: a draw from the bounded
// Gaussian head, or its mean when sample == 0.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(TC_THREADS, 1)
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
  if (__shfl_sync(0xffffffffu, threadIdx.x, 0) >= TC_CONSUMERS) {  // the producer warp
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0;
      produce_chain<BF16>(d, smem, ws + (size_t)e * d.w_member * TC<BF16>::ESIZE, it);
    }
    return;
  }
  unsigned char* a_buf = smem + TC_BARRIER_BYTES;
  const int din = d.dims[0], k0 = d.kp[0];
  const float* xe = x + ((size_t)e * S + row0) * din;
  float* lvb = reinterpret_cast<float*>(smem + d.extra_off);  // max, then min logvar
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

  const float* head = reinterpret_cast<const float*>(a_buf);
  const int nh = d.np[d.num_products - 1];
  const uint2 key = make_uint2(seed0, seed1);
  float* o = out + ((size_t)e * S + row0) * out_size;
  for (int idx = threadIdx.x; idx < rows * out_size; idx += TC_CONSUMERS) {
    const int r = idx / out_size, c = idx - r * out_size;
    const uint4 ctr = make_uint4((uint32_t)(row0 + r), (uint32_t)c, 0u, (uint32_t)e);
    o[idx] = head_draw(head[r * nh + c], head[r * nh + out_size + c], lvb[c], lvb[128 + c],
                       sample, ctr, key);
  }
  TC_STAMP(31)
}

// ---------------------------------------------------------------------------
// K1: the whole H-step rollout. grid = (num_tiles,), one block per row tile
// of `tile` (<= TC_ROWS) rows, looping over the steps inside the block. The
// obs carry and the running total stay in shared memory for all H steps; per
// step only the (tile, A) action slab is read from device memory. Row tile i
// uses member ((i + rot[t]) % num_tiles) / tiles_per_member at step t.
template <int ACT, bool BF16>
__global__ void __launch_bounds__(TC_THREADS, 1)
rollout_returns_tc_kernel(uint32_t seed0, uint32_t seed1, const int* __restrict__ rot,
                          const float* __restrict__ obs0, const float* __restrict__ acts,
                          const float* __restrict__ dmask, const unsigned char* __restrict__ ws,
                          const float* __restrict__ bs, const float* __restrict__ max_lv,
                          const float* __restrict__ min_lv, float* __restrict__ out,
                          const ChainDesc d, int obs_dim, int act_dim, int horizon, int out_size,
                          int tile, int num_tiles, int tiles_per_member, int sample) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int i = blockIdx.x;
  const int row0 = i * tile;
  init_barriers(d, smem);
  if (__shfl_sync(0xffffffffu, threadIdx.x, 0) >= TC_CONSUMERS) {  // the producer warp
    if (threadIdx.x == TC_CONSUMERS) {
      uint32_t it = 0;
      for (int t = 0; t < horizon; ++t) {
        const int m = ((i + rot[t]) % num_tiles) / tiles_per_member;
        produce_chain<BF16>(d, smem, ws + (size_t)m * d.w_member * TC<BF16>::ESIZE, it);
      }
    }
    return;
  }
  unsigned char* a_buf = smem + TC_BARRIER_BYTES;
  const float* head = reinterpret_cast<const float*>(a_buf);
  float* lvb = reinterpret_cast<float*>(smem + d.extra_off);  // max, then min logvar
  float* obs = lvb + TC_BOUNDS_BYTES / 4;                     // (TC_ROWS, obs_dim) carry
  float* total = obs + TC_ROWS * obs_dim;                     // (TC_ROWS,) running return
  const int din = obs_dim + act_dim, k0 = d.kp[0];
  const int nh = d.np[d.num_products - 1];
  const uint2 key = make_uint2(seed0, seed1);

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
    const int m = ((i + rot[t]) % num_tiles) / tiles_per_member;
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
    consume_chain<ACT, BF16>(d, smem, bs + (size_t)m * d.b_member, it);
    // one thread per (row, output column): the last column is the learned
    // reward, the others are delta (dmask = 1) or absolute next-obs targets
    for (int idx = threadIdx.x; idx < tile * out_size; idx += TC_CONSUMERS) {
      const int r = idx / out_size, c = idx - r * out_size;
      const uint4 ctr = make_uint4((uint32_t)(row0 + r), (uint32_t)c, (uint32_t)t, (uint32_t)i);
      const float pred = head_draw(head[r * nh + c], head[r * nh + out_size + c], lvb[c],
                                   lvb[128 + c], sample, ctr, key);
      if (c < out_size - 1) {
        const float dm = dmask[c];
        obs[r * obs_dim + c] = dm * (obs[r * obs_dim + c] + pred) + (1.0f - dm) * pred;
      } else {
        total[r] += pred;
      }
    }
    consumer_sync();
  }
  for (int r = threadIdx.x; r < tile; r += TC_CONSUMERS) out[row0 + r] = total[r];
}

// ---------------------------------------------------------------------------
// Host side

static int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The layout and the shared-memory plan; false if the chain does not fit.
template <bool BF16>
static bool make_chain_desc(const int* dims, int num_products, int extra_bytes, ChainDesc* d,
                            size_t* smem) {
  using C = TC<BF16>;
  if (num_products < 1 || num_products > MAX_PRODUCTS) return false;
  d->num_products = num_products;
  for (int i = 0; i <= num_products; ++i) {
    if (dims[i] < 1 || dims[i] > TC_MAX_WIDTH) return false;
    d->dims[i] = dims[i];
  }
  long long w = 0;
  int b = 0, kmax = 0, stage = 0;
  for (int i = 0; i < num_products; ++i) {
    d->kp[i] = round_up(dims[i], C::KSTEP);
    d->np[i] = round_up(dims[i + 1], i + 1 < num_products ? C::KSTEP : 8);
    d->w_off[i] = w;
    d->b_off[i] = b;
    w += (long long)d->kp[i] * d->np[i] * C::COPIES;
    b += dims[i + 1];
    kmax = kmax > d->kp[i] ? kmax : d->kp[i];
    const int chunk = (C::CHUNK < d->kp[i] ? C::CHUNK : d->kp[i]) * d->np[i] * C::ESIZE * C::COPIES;
    stage = stage > chunk ? stage : chunk;
  }
  d->w_member = w;
  d->b_member = b;
  d->a_copy_bytes = TC_ROWS * kmax * C::ESIZE;
  const int head_bytes = TC_ROWS * d->np[num_products - 1] * (int)sizeof(float);
  const int a_bytes = C::COPIES * d->a_copy_bytes;
  d->a_bytes = round_up(a_bytes > head_bytes ? a_bytes : head_bytes, 128);
  d->stage_bytes = stage;
  extra_bytes += TC_BOUNDS_BYTES;
  const int fixed = TC_BARRIER_BYTES + d->a_bytes;
  const int stages = (TC_SMEM_LIMIT - fixed - extra_bytes) / stage;
  d->stages = stages < TC_MAX_STAGES ? stages : TC_MAX_STAGES;
  if (d->stages < 2) return false;
  d->extra_off = fixed + d->stages * stage;
  *smem = (size_t)d->extra_off + extra_bytes;
  return true;
}

static bool make_chain_desc(bool bf16, const int* dims, int num_products, int extra_bytes,
                            ChainDesc* d, size_t* smem) {
  return bf16 ? make_chain_desc<true>(dims, num_products, extra_bytes, d, smem)
              : make_chain_desc<false>(dims, num_products, extra_bytes, d, smem);
}

// Lets KERNEL use all the shared memory a block can have; once per process
// (the attribute holds for every later launch).
template <auto KERNEL>
static cudaError_t prepare_once() {
  static const cudaError_t err = prepare(KERNEL, TC_SMEM_LIMIT);
  return err;
}

#define LAUNCH_K2(ACT, BF16, grid, smem, stream, ...)                                  \
  {                                                                                    \
    cudaError_t err = prepare_once<gaussian_tc_kernel<ACT, BF16>>();                   \
    if (err != cudaSuccess) return err;                                                \
    gaussian_tc_kernel<ACT, BF16><<<grid, TC_THREADS, smem, stream>>>(__VA_ARGS__);    \
  }

#define LAUNCH_K1(ACT, BF16, grid, smem, stream, ...)                                  \
  {                                                                                    \
    cudaError_t err = prepare_once<rollout_returns_tc_kernel<ACT, BF16>>();            \
    if (err != cudaSuccess) return err;                                                \
    rollout_returns_tc_kernel<ACT, BF16><<<grid, TC_THREADS, smem, stream>>>(__VA_ARGS__); \
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
  if (!make_chain_desc(bf16, dims, num_products, 0, &d, &smem) || rows < 1 ||
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
  const int extra = (int)sizeof(float) * (TC_ROWS * obs_dim + TC_ROWS);
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
