// The member chain that the three kernels share (sm_90a): the weight layout's
// descriptor, the PTX wrappers, the wgmma products, and the producer and
// consumer sides of the weight ring. tc_chain.cu (K1, K2) and ensemble_mlp.cu
// (K3) include it and are compiled each by its own nvcc; every function here
// is a template, inline or static, so the two objects link side by side.
// The design is described at the top of tc_chain.cu.
#pragma once

#include "common.cuh"
#include "wgmma_ops.cuh"

#define TC_ROWS 64                        // rows of one tile (one wgmma M)
#define TC_CONSUMERS 256                  // two warpgroups, each half of N
#define TC_THREADS (TC_CONSUMERS + 32)    // + one producer warp (the wide route)
#define TC_CHAIN_THREADS (TC_CONSUMERS + 128)  // the chain: + a producer warpgroup
#define TC_NOISE_THREADS 96               // its last three warps: the kernels' normals
#define TC_MAX_WIDTH 256                  // widest layer: N/2 <= 128 per warpgroup
#define TC_MAX_STAGES 4
#define TC_SMEM_LIMIT 232448              // shared memory one block can use
#define TC_BARRIER_BYTES 128              // full[s] at 8s, empty[s] at 64 + 8s,
#define TC_NOISE_FULL 32                  // noise_full[b] at 32 + 8b,
#define TC_NOISE_EMPTY 48                 // noise_empty[b] at 48 + 8b (b < 2)
#define TC_BOUNDS_BYTES 1024              // the head's logvar bounds: 2 x 128 floats
#define ACC_REGS 64                       // f32 accumulators for N = 128
#define TC_HEAD_SPLIT 40                  // the widest (padded) head split by K

// Timeline instrumentation, compiled only with -DTC_TIMELINE (see
// ops/chain_timeline.py): warpgroup w's thread 0 of block (0, 0) writes
// %globaltimer at mark k to tc_timeline[k + 32 w] (w = 2: the producer
// thread); TC_STAMP_IF only where `cond` holds too, TC_STAMP_AT from any
// thread where `cond` holds, to slot `slot`. Predicated, not branched, so
// that it leaves the wgmma pipeline as it is. Each source has its own marks
// and its own reader.
#ifdef TC_TIMELINE
static __device__ unsigned long long tc_timeline[96];
#define TC_STAMP_AT(slot, cond)                                                       \
  {                                                                                    \
    unsigned long long now;                                                            \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));                            \
    const int on = blockIdx.x == 0 && blockIdx.y == 0 && (cond);                       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\n@p st.global.u64 [%0], %1;\n}\n" \
                 ::"l"(tc_timeline + (slot)), "l"(now), "r"(on)                           \
                 : "memory");                                                          \
  }
#define TC_STAMP_IF(k, cond) \
  TC_STAMP_AT((k) + 32 * (threadIdx.x >> 7), (threadIdx.x & 127) == 0 && (cond))
#else
#define TC_STAMP_AT(slot, cond)
#define TC_STAMP_IF(k, cond)
#endif
#define TC_STAMP(k) TC_STAMP_IF(k, true)

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
  int extra_off;                   // logvar bounds, then the kernel's own (normals, carry)
  int head_split;                  // the head is split by K: two partial tiles (head_at)
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

// barrier of the consumer warpgroups only (the producer never joins)
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
    TC_CASE(16)
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
// A narrow head split by K. Every other product splits its columns between
// the warpgroups; a head of at most TC_HEAD_SPLIT (padded) columns would
// leave warpgroup 1 little or nothing, and warpgroup 0 a run of short
// dependent instructions (75 at E's head of 8). Both warpgroups take all its
// columns instead, warpgroup w the k-steps q = w, w + 2, ... of every chunk,
// on its accumulators (the first instruction overwrites them, scale-d = 0);
// the epilogue adds warpgroup 0's bias and leaves two partial tiles, which
// head_at adds where the head is read.

// This warpgroup's J k-steps of the chunk, every other one from the k-step
// `a`/`b` point at.
template <int N, int J, bool BF16>
__device__ __forceinline__ void issue_split_chunk(int first, float* acc, uint32_t a, uint32_t a_lo,
                                                 uint32_t b, uint32_t b_lo, uint32_t b_lbo) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const uint64_t da = smem_desc(a + j * 4 * (8 * 128), 8 * 128, 128);
    const uint64_t db = smem_desc(b + j * 4 * b_lbo, b_lbo, 128);
    const int add = !first || j > 0;
    if constexpr (BF16) {
      wgmma_bf16<N>(acc, da, db, add);
    } else {  // 3xTF32, the small cross terms first
      const uint64_t da_lo = smem_desc(a_lo + j * 4 * (8 * 128), 8 * 128, 128);
      const uint64_t db_lo = smem_desc(b_lo + j * 4 * b_lbo, b_lbo, 128);
      wgmma_tf32<N>(acc, da_lo, db, add);
      wgmma_tf32<N>(acc, da, db_lo, 1);
      wgmma_tf32<N>(acc, da, db, 1);
    }
  }
}

// Each case is a whole pipeline stage: fence, the products, commit.
template <int J, bool BF16>
__device__ __forceinline__ void issue_split_steps(int n8, int first, float* acc, uint32_t a,
                                                  uint32_t a_lo, uint32_t b, uint32_t b_lo,
                                                  uint32_t b_lbo) {
  switch (n8) {
#define TC_CASE(K)                                                                  \
  case K:                                                                           \
    wgmma_fence();                                                                  \
    issue_split_chunk<8 * K, J, BF16>(first, acc, a, a_lo, b, b_lo, b_lbo);         \
    wgmma_commit();                                                                 \
    break;
    TC_CASE(1) TC_CASE(2) TC_CASE(3) TC_CASE(4) TC_CASE(5)
#undef TC_CASE
    default:
      wgmma_commit();
  }
}

// This warpgroup's k k-steps of a chunk of a split head, as one commit group
// (none: an empty group, which keeps the count).
template <int S, bool BF16>
__device__ __forceinline__ void issue_split(int k, int n8, int first, float* acc, uint32_t a,
                                            uint32_t a_lo, uint32_t b, uint32_t b_lo,
                                            uint32_t b_lbo) {
  if constexpr (S == 0) {
    wgmma_commit();
  } else if (k == S) {
    issue_split_steps<S, BF16>(n8, first, acc, a, a_lo, b, b_lo, b_lbo);
  } else {
    issue_split<S - 1, BF16>(k, n8, first, acc, a, a_lo, b, b_lo, b_lbo);
  }
}

// The head's output (r, c), f32: the one tile, or the sum of the two
// partial tiles of a head split by K (the first holds the bias).
__device__ __forceinline__ float head_at(const ChainDesc& d, const float* head, int r, int c) {
  const int nh = d.np[d.num_products - 1];
  const float v = head[r * nh + c];
  return d.head_split ? v + head[TC_ROWS * nh + r * nh + c] : v;
}

// A hidden layer's epilogue for a warpgroup of n8 <= J column groups: the
// bias, the activation and the next product's A operand for every group
// below J, with no branch between groups (the activations of one overlap the
// next's), each group stored only if it is one of the n8.
template <int J, int ACT, bool BF16>
__device__ __forceinline__ void store_hidden(unsigned char* a_buf, int a_copy_bytes, const float* acc,
                                             const float* bia, int n8, int n0, int dout, int r) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = n0 + 2 * (threadIdx.x & 3) + 8 * j;
    const bool in0 = c < dout, in1 = c + 1 < dout;
    const float b0 = bia[2 * j], b1 = bia[2 * j + 1];
    const float y00 = in0 ? tc_activate<ACT>(acc[4 * j] + b0) : 0.0f;
    const float y01 = in1 ? tc_activate<ACT>(acc[4 * j + 1] + b1) : 0.0f;
    const float y10 = in0 ? tc_activate<ACT>(acc[4 * j + 2] + b0) : 0.0f;
    const float y11 = in1 ? tc_activate<ACT>(acc[4 * j + 3] + b1) : 0.0f;
    if (j < n8) {
      store_a2<BF16>(a_buf, a_copy_bytes, r, c, y00, y01);
      store_a2<BF16>(a_buf, a_copy_bytes, r + 8, c, y10, y11);
    }
  }
}

// ---------------------------------------------------------------------------
// The chain: producer and consumer warpgroups. `it` counts chunks over
// the launch on both sides, so stage = it % stages and parity = it / stages.

__device__ __forceinline__ void init_barriers(const ChainDesc& d, unsigned char* smem) {
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(smem);
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                        // full: the producer's expect_tx
      mbar_init(bars + 64 + 8 * s, TC_CONSUMERS / 32);   // empty: one arrive per warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(bars + TC_NOISE_FULL + 8 * b, TC_NOISE_THREADS);  // every noise thread, its draws done
      mbar_init(bars + TC_NOISE_EMPTY + 8 * b, 1);       // consumer thread 0, the normals read
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Chunks of product i that one ring buffer holds: one, or for a head split
// by K as many whole ones as fit (all 13 of E's f32 head of 8 columns, whose
// 16-row chunks are 1 KB: one copy instead of a round trip of the ring each).
template <bool BF16>
__device__ __forceinline__ int ring_chunks(const ChainDesc& d, int i) {
  using C = TC<BF16>;
  if (i + 1 < d.num_products || !d.head_split) return 1;
  return max(1, d.stage_bytes / (C::CHUNK * d.np[i] * C::ESIZE * C::COPIES));
}

// Streams member `wm`'s chunks, product by product, into the ring (one
// thread: the producer warpgroup's first), a ring buffer's worth of whole
// chunks (ring_chunks) a copy; the packed layout holds a product's chunks in
// order, so they are one contiguous run.
template <bool BF16>
__device__ __forceinline__ void produce_chain(const ChainDesc& d, unsigned char* smem,
                                              const unsigned char* wm, uint32_t& it) {
  using C = TC<BF16>;
  const uint32_t bars = smem_u32(smem);
  const uint32_t stage0 = bars + TC_BARRIER_BYTES + d.a_bytes;
  const unsigned char* src = wm;
  for (int i = 0; i < d.num_products; ++i) {
    const int run = ring_chunks<BF16>(d, i) * C::CHUNK;
    for (int k0 = 0; k0 < d.kp[i]; k0 += run) {
      const uint32_t bytes = min(run, d.kp[i] - k0) * d.np[i] * C::ESIZE * C::COPIES;
      const int s = it % d.stages;
      mbar_wait(bars + 64 + 8 * s, ((it / d.stages) & 1) ^ 1);
      mbar_expect_tx(bars + 8 * s, bytes);
      bulk_load(stage0 + s * d.stage_bytes, src, bytes, bars + 8 * s);
      src += bytes;
      ++it;
    }
  }
}

// The last product, a head split by K (d.head_split), for warpgroup `wg`:
// both warpgroups take all its columns and every other k-step, and leave
// two partial (TC_ROWS, np) f32 tiles at the start of the A region. A ring
// buffer holds as many whole chunks of it as fit (ring_chunks), each chunk
// one commit group. Ends with a consumer barrier.
template <bool BF16>
__device__ __forceinline__ void consume_split_head(const ChainDesc& d, unsigned char* smem,
                                                   const float* bias, int wg, uint32_t& it) {
  using C = TC<BF16>;
  const uint32_t bars = smem_u32(smem);
  const uint32_t a_addr = bars + TC_BARRIER_BYTES;
  const uint32_t stage0 = a_addr + d.a_bytes;
  const int lane = threadIdx.x & 31;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int i = d.num_products - 1, kp = d.kp[i], np = d.np[i], n8 = np / 8;
  const uint32_t b_lbo = np * 16;
  // warpgroup 0's biases, loaded now so that the loads overlap the products
  const float* b = bias + d.b_off[i];
  const int dout = wg ? 0 : d.dims[i + 1];
  float bia[TC_HEAD_SPLIT / 4];
#pragma unroll
  for (int j = 0; j < TC_HEAD_SPLIT / 8; ++j) {
    const int c = 2 * (lane & 3) + 8 * j;
    bia[2 * j] = c < dout ? __ldg(b + c) : 0.0f;
    bia[2 * j + 1] = c + 1 < dout ? __ldg(b + c + 1) : 0.0f;
  }
  float acc[TC_HEAD_SPLIT / 2];
  const int run = ring_chunks<BF16>(d, i) * C::CHUNK;  // K rows a ring buffer holds
  const uint32_t chunk_bytes = C::CHUNK * np * C::ESIZE * C::COPIES;
  int prev = -1;  // the previous ring buffer, freed once its products are done
  for (int k0 = 0; k0 < kp; k0 += run) {
    const int s = it % d.stages;
    mbar_wait(bars + 8 * s, (it / d.stages) & 1);
    for (int k1 = k0; k1 < min(k0 + run, kp); k1 += C::CHUNK) {
      const int steps = min(C::CHUNK, kp - k1) / C::KSTEP;
      const uint32_t st = stage0 + s * d.stage_bytes + (k1 - k0) / C::CHUNK * chunk_bytes +
                          wg * 2 * b_lbo;
      const uint32_t lo = min(C::CHUNK, kp - k1) * np * C::ESIZE;  // the lo block follows hi
      const uint32_t a = a_addr + (k1 / C::T) * (8 * 128) + wg * 2 * (8 * 128);
      issue_split<(C::CHUNK / C::KSTEP + 1) / 2, BF16>((steps + 1 - wg) / 2, n8, k1 == 0, acc, a,
                                                      a + d.a_copy_bytes, st, st + lo, b_lbo);
      wgmma_wait<1>();  // the previous group is done: on a buffer's first, free the last buffer
      mbar_arrive(bars + 64 + 8 * max(prev, 0), lane == 0 && prev >= 0 && k1 == k0);
    }
    prev = s;
    ++it;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < TC_HEAD_SPLIT / 2; ++j) asm volatile("" : "+f"(acc[j])::"memory");
  TC_STAMP(3 + 3 * i)
  mbar_arrive(bars + 64 + 8 * prev, lane == 0);
  consumer_sync();  // every warp's products have read A before it is overwritten
  TC_STAMP(4 + 3 * i)
  // warpgroup 1 has nothing if the first chunk had no k-step for it
  const bool any = wg < min(C::CHUNK, kp) / C::KSTEP;
  float* out = reinterpret_cast<float*>(smem + TC_BARRIER_BYTES) + wg * TC_ROWS * np;
#pragma unroll
  for (int j = 0; j < TC_HEAD_SPLIT / 8; ++j) {
    if (j < n8) {
      const int c = 2 * (lane & 3) + 8 * j;
      const float b0 = bia[2 * j], b1 = bia[2 * j + 1];
      *reinterpret_cast<float2*>(out + r * np + c) =
          any ? make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1) : make_float2(0.0f, 0.0f);
      *reinterpret_cast<float2*>(out + (r + 8) * np + c) =
          any ? make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1) : make_float2(0.0f, 0.0f);
    }
  }
  consumer_sync();
  TC_STAMP(5 + 3 * i)
}

// Runs the member's chain on the tile in the A region (written and fenced by
// the caller). Hidden layers leave their output in A; the head leaves
// (TC_ROWS, np[last]) f32 at the start of the A region (two partial tiles if
// d.head_split: consume_split_head; read it with head_at). Ends with a
// consumer barrier.
template <int ACT, bool BF16>
__device__ __forceinline__ void consume_chain(const ChainDesc& d, unsigned char* smem,
                                              const float* bias, uint32_t& it) {
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
  for (int i = 0; i < d.num_products - d.head_split; ++i) {
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
      TC_STAMP_IF(27, i == 0 && k0 == 0)  // the chain's first chunk landed
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
      if constexpr (BF16) {
        // compiled for a few widths, a warpgroup's columns rounded up to one
        // (a 208-wide layer: 13 groups on each); in f32 this measured slower
        // than the loop below
        if (n8 <= 4) {
          store_hidden<4, ACT, BF16>(a_buf, d.a_copy_bytes, acc, bia, n8, n0, dout, r);
        } else if (n8 <= 8) {
          store_hidden<8, ACT, BF16>(a_buf, d.a_copy_bytes, acc, bia, n8, n0, dout, r);
        } else if (n8 <= 12) {
          store_hidden<12, ACT, BF16>(a_buf, d.a_copy_bytes, acc, bia, n8, n0, dout, r);
        } else if (n8 == 13) {
          store_hidden<13, ACT, BF16>(a_buf, d.a_copy_bytes, acc, bia, n8, n0, dout, r);
        } else {
          store_hidden<16, ACT, BF16>(a_buf, d.a_copy_bytes, acc, bia, n8, n0, dout, r);
        }
      } else {
        for_each_acc(acc, n8, n0, [&](int j, float v00, float v01, float v10, float v11, int c) {
          const bool in0 = c < dout, in1 = c + 1 < dout;
          const float b0 = bia[2 * j], b1 = bia[2 * j + 1];
          store_a2<BF16>(a_buf, d.a_copy_bytes, r, c, in0 ? tc_activate<ACT>(v00 + b0) : 0.0f,
                         in1 ? tc_activate<ACT>(v01 + b1) : 0.0f);
          store_a2<BF16>(a_buf, d.a_copy_bytes, r + 8, c, in0 ? tc_activate<ACT>(v10 + b0) : 0.0f,
                         in1 ? tc_activate<ACT>(v11 + b1) : 0.0f);
        });
      }
      TC_STAMP(18 + min(i, 3))  // the first four epilogues' stores issued
      fence_proxy_async();
      TC_STAMP(22 + min(i, 3))  // and fenced for the next product
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
  if (d.head_split) consume_split_head<BF16>(d, smem, bias, wg, it);
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
  d->head_split = d->np[num_products - 1] <= TC_HEAD_SPLIT;
  const int head_bytes =
      TC_ROWS * d->np[num_products - 1] * (int)sizeof(float) * (d->head_split ? 2 : 1);
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
