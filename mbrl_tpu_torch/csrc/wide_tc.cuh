// The wide tensor-core chain of K1, K2 and K3 (sm_90a): any width and depth
// on wgmma, with the activations streamed from a per-block scratch in device
// memory beside the weights, or resident in shared memory (K1 and K2 in
// bf16, K3 up to 512 columns). wide_tc.cu holds K1's and K2's entries and
// the design note, wide_rollout.cuh their kernels, ensemble_mlp_wide.cu K3's
// entry and its scratch route, ensemble_mlp_wide_smem.cu its resident one;
// the PTX wrappers, the wgmma products and the operand layouts are the
// chain's (tc_chain.cuh), which this header reuses unchanged.
#pragma once

#include <limits.h>

#include "tc_chain.cuh"

#define WT_PASS 256           // output columns of one pass: two warpgroups x 128
#define WT_BARRIER_BYTES 128  // full[s] at 8s, the ready barrier at 32, empty[s] at 64 + 8s
#define WT_READY 32
#define WT_MAX_CLUSTER 2      // blocks of a K1/K2 cluster at most (wide_cluster.cu)
#define WT_SMEM_MIN_STAGES 3  // ring buffers the resident-activation plan needs at least

// Mirrors WideTileLayout in ops/kernels.py. Product i is a zero-padded
// (kp_i, np_i) matrix (K to the instruction depth, N to the next K, the head's
// N to 8), packed pass by pass (WT_PASS columns, the last narrower), then in K
// chunks of TC<BF16>::CHUNK rows, each chunk hi then lo for f32: one bulk copy
// a chunk, in wgmma's B layout at the pass's width.
struct WideDesc {
  int num_products;
  long long w_member;     // tile elements per member
  int b_member;           // bias elements per member
  long long a_buf_bytes;  // one activation buffer: TC_ROWS x max kp, every copy
  long long head_off;     // the head's (TC_ROWS, head_ld) f32 in the block's scratch
  int head_ld;            // n_pad of the head
  long long carry_off;    // K1: obs carry (TC_ROWS, obs_dim) f32, then the running return
  long long block_bytes;  // scratch of one block, a multiple of 128
  int stage_bytes;        // one ring buffer: an A chunk slot, then a B chunk
  int stages;
};

// K3's arguments on the wide route: x (E, S, in) f32 -> out (E, S, head_out)
// f32, raw head; `ws` pack_wide's tiles, `dims` the stack's dims in device
// memory; the member-major (member, 64-row tile) list has `total` entries,
// `num_tiles` a member; `act` the activation's code
struct K3Args {
  const float* x;
  const unsigned char* ws;
  const float* bs;
  float* out;
  const int* dims;
  WideDesc d;
  int S, num_tiles, total, act;
};

// ensemble_mlp_wide_smem.cu: K3 with a tile's activations resident in shared
// memory (make_wide_smem_desc's plan in a.d)
cudaError_t launch_k3_wide_smem(int bf16, dim3 grid, size_t smem, cudaStream_t stream,
                                const K3Args& a);

// K rows of one ring buffer of K3's resident route, every pass of a product:
// one k-step f32, two bf16 (32 KB at 512 columns)
template <bool BF16>
__host__ __device__ constexpr int wt_slice() {
  return BF16 ? 32 : 8;
}

// one ring buffer's A chunk slot: TC_ROWS x CHUNK, every copy (8 KB for both dtypes)
template <bool BF16>
__host__ __device__ constexpr int wt_a_slot() {
  return TC_ROWS * TC<BF16>::CHUNK * TC<BF16>::ESIZE * TC<BF16>::COPIES;
}

__host__ __device__ __forceinline__ int wt_round_up(int x, int m) { return (x + m - 1) / m * m; }

// a value every lane of the warp holds: the shuffle tells ptxas so, which
// keeps the wgmma pipeline from being serialized behind it
__device__ __forceinline__ int uniform(int v) { return __shfl_sync(0xffffffffu, v, 0); }

// generic-proxy stores to device memory become visible to the bulk copies
// (async proxy) that a later barrier orders after them
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// ---------------------------------------------------------------------------
// Clusters (K1 and K2, wide_cluster.cu): the blocks of a cluster share each
// weight chunk of the ring, fetched once by one of them and multicast into
// every block's ring buffer at the same offset.

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return (int)n;
}

// Every thread of every block of the cluster, converged or not: after it,
// what each block did before (barrier set-up, copies landed, arrivals) is
// visible to all, so no block leaves while a peer can still reach it.
__device__ __forceinline__ void wide_cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// One bulk copy into shared memory at `dst` of every block in `mask`, each
// block's barrier at offset `bar` told of its bytes.
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// One arrival on barrier `bar` of each of the cluster's first `blocks`
// blocks, from the threads where `on` is true (predicated, unrolled: no
// branch near the wgmma).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int blocks, bool on) {
#pragma unroll
  for (int q = 0; q < WT_MAX_CLUSTER; ++q) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 remote;\nsetp.ne.u32 p, %2, 0;\n"
        "@p mapa.shared::cluster.u32 remote, %0, %1;\n"
        "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
        "r"(q), "r"((int)on & (int)(q < blocks))
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// The activation buffers: product i's input (TC_ROWS, kp_i) in K chunks of
// CHUNK columns, chunk after chunk, each chunk its copies (bf16; tf32 hi, lo)
// in the chain's A layout (a_index), so that one bulk copy lands a chunk in a
// ring buffer ready for wgmma.

// A[r, c] (copy 0) of a buffer whose K is kp; `lo` = bytes to copy 1
template <bool BF16>
__device__ __forceinline__ unsigned char* wide_a_ptr(unsigned char* buf, int kp, int r, int c,
                                                     int& lo) {
  using C = TC<BF16>;
  const int k0 = c / C::CHUNK * C::CHUNK;
  lo = TC_ROWS * min(C::CHUNK, kp - k0) * C::ESIZE;
  return buf + (size_t)k0 * TC_ROWS * C::ESIZE * C::COPIES + a_index<BF16>(r, c - k0) * C::ESIZE;
}

template <bool BF16>
__device__ __forceinline__ void store_wide_a(unsigned char* buf, int kp, int r, int c, float v) {
  int lo;
  unsigned char* p = wide_a_ptr<BF16>(buf, kp, r, c, lo);
  if constexpr (BF16) {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
  } else {
    const float hi = to_tf32(v);
    *reinterpret_cast<float*>(p) = hi;
    *reinterpret_cast<float*>(p + lo) = to_tf32(v - hi);
  }
}

// A[r, c:c+2] = (v0, v1), c even
template <bool BF16>
__device__ __forceinline__ void store_wide_a2(unsigned char* buf, int kp, int r, int c, float v0,
                                              float v1) {
  int lo;
  unsigned char* p = wide_a_ptr<BF16>(buf, kp, r, c, lo);
  if constexpr (BF16) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    const float h0 = to_tf32(v0), h1 = to_tf32(v1);
    *reinterpret_cast<float2*>(p) = make_float2(h0, h1);
    *reinterpret_cast<float2*>(p + lo) = make_float2(to_tf32(v0 - h0), to_tf32(v1 - h1));
  }
}

// The chain's input (TC_ROWS, din) into buffer 0, value(r, c) for c < din and
// zero up to kp; then fenced and announced to the producer (ready barrier).
// Consecutive threads write consecutive 16-byte core-matrix rows.
template <bool BF16, typename F>
__device__ __forceinline__ void stage_wide_input(unsigned char* smem, unsigned char* buf, int din,
                                                 F value) {
  using C = TC<BF16>;
  const int kp = wt_round_up(din, C::KSTEP);
  for (int idx = threadIdx.x; idx < TC_ROWS * kp; idx += TC_CONSUMERS) {
    const int cg = idx / (TC_ROWS * C::T), rem = idx - cg * (TC_ROWS * C::T);
    const int r = rem / C::T, c = cg * C::T + rem % C::T;
    store_wide_a<BF16>(buf, kp, r, c, c < din ? value(r, c) : 0.0f);
  }
  fence_proxy_async_global();
  mbar_arrive(smem_u32(smem) + WT_READY, true);
}

// The producer's wait for ring buffer `bar` to be free. Under -DTC_TIMELINE,
// where `timed`, it adds the ns it waited to `waited` (TC_RECORD stores the
// sum at the end, as a duration): in a cluster, the wait for every consumer
// of every block to release the buffer.
__device__ __forceinline__ void wait_free(uint32_t bar, uint32_t parity, bool timed,
                                          unsigned long long& waited) {
#ifdef TC_TIMELINE
  unsigned long long w0, w1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(w0));
  mbar_wait(bar, parity);
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(w1));
  if (timed) waited += w1 - w0;
#else
  mbar_wait(bar, parity);
#endif
}

#ifdef TC_TIMELINE
#define TC_RECORD(slot, value) \
  if (blockIdx.x == 0 && blockIdx.y == 0) tc_timeline[slot] = (value);
#else
#define TC_RECORD(slot, value)
#endif

// ---------------------------------------------------------------------------
// The chain: producer warp and consumer warpgroups. `it` counts ring buffers
// over the launch on both sides (stage = it % stages, parity = it / stages);
// the producer's `ready` counts the ready barrier's phases.
//
// Timeline marks (-DTC_TIMELINE), product i at j = 3 + 3 min(i, 7): the
// consumers' j its first chunk landed, j + 1 its products done, j + 2 its
// epilogue fenced and handed on (the head: whole); the producer's j the
// ready barrier passed, j + 1 its last copy issued.

// CLUSTER: the block is one of `blocks` in a cluster; a ring buffer is free
// once every consumer warp of the cluster has released it, and the set-up is
// made visible to the peers before any of them copies or arrives here.
template <bool CLUSTER = false>
__device__ __forceinline__ void init_wide_barriers(const WideDesc& d, unsigned char* smem,
                                                   int blocks = 1) {
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(smem);
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(bars + 8 * s, 1);  // full: the producer's expect_tx
      // empty: one arrive per consumer warp (of every block of the cluster)
      mbar_init(bars + 64 + 8 * s, TC_CONSUMERS / 32 * (CLUSTER ? blocks : 1));
    }
    mbar_init(bars + WT_READY, TC_CONSUMERS);  // ready: every consumer thread, after its fence
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (CLUSTER) {
    wide_cluster_sync();
  } else {
    __syncthreads();
  }
}

// Streams one chain of member `wm` on the block's scratch `act`: per product,
// per pass, per K chunk, the weight chunk and the activation chunk into one
// ring buffer. A product's activations are read only after the consumers
// have written and fenced them (the ready barrier); its first weight chunk is
// in flight before that wait.
//
// CLUSTER, `share` > 1: the cluster's first `share` blocks run the same
// member's chain in step, and block it % share (by `rank`) fetches ring
// buffer it's weight chunk for all of them, multicast into each one's buffer
// and barrier at the same offset; the others copy only their activation
// chunk. Every block's full barrier still expects both chunks' bytes, and
// every block waits on its own empty barrier, which counts the releases of
// every consumer warp of the cluster, so no peer's buffer is refilled while
// a consumer reads it. `share` 1: each block copies its own weights.
//
// Timeline: beside the per-product marks, at 29 the ns the producer waited
// on empty barriers during product 1 (wait_free; a duration, not a time).
template <bool BF16, bool CLUSTER = false>
__device__ void produce_wide(const WideDesc& d, const int* __restrict__ dims, unsigned char* smem,
                             const unsigned char* wm, const unsigned char* act, uint32_t& it,
                             uint32_t& ready, int share = 1, int rank = 0) {
  using C = TC<BF16>;
  const uint32_t bars = smem_u32(smem);
  const uint32_t stage0 = bars + WT_BARRIER_BYTES;
  const unsigned char* src = wm;
  unsigned long long waited = 0;  // the timeline's: ns waited on empty barriers
  for (int i = 0; i < d.num_products; ++i) {
    const bool hidden = i + 1 < d.num_products;
    const int kp = wt_round_up(__ldg(dims + i), C::KSTEP);
    const int np = wt_round_up(__ldg(dims + i + 1), hidden ? C::KSTEP : 8);
    const unsigned char* a_src = act + (i & 1) * d.a_buf_bytes;
    for (int p0 = 0; p0 < np; p0 += WT_PASS) {
      const int npass = min(WT_PASS, np - p0);
      for (int k0 = 0; k0 < kp; k0 += C::CHUNK) {
        const int kc = min(C::CHUNK, kp - k0);
        const uint32_t a_bytes = TC_ROWS * kc * C::ESIZE * C::COPIES;
        const uint32_t b_bytes = kc * npass * C::ESIZE * C::COPIES;
        const int s = it % d.stages;
        const uint32_t st = stage0 + s * d.stage_bytes;
        wait_free(bars + 64 + 8 * s, ((it / d.stages) & 1) ^ 1, i == 1, waited);
        mbar_expect_tx(bars + 8 * s, a_bytes + b_bytes);
        if (!CLUSTER || share == 1) {
          bulk_load(st + wt_a_slot<BF16>(), src, b_bytes, bars + 8 * s);
        } else if ((int)(it % share) == rank) {
          bulk_load_multicast(st + wt_a_slot<BF16>(), src, b_bytes, bars + 8 * s,
                              (uint16_t)((1u << share) - 1));
        }
        src += b_bytes;
        if (p0 == 0 && k0 == 0) {  // the product's input is whole
          mbar_wait(bars + WT_READY, ready & 1);
          ++ready;
          TC_STAMP(3 + 3 * min(i, 7))
        }
        bulk_load(st, a_src + (size_t)k0 * TC_ROWS * C::ESIZE * C::COPIES, a_bytes, bars + 8 * s);
        ++it;
      }
    }
    TC_STAMP(4 + 3 * min(i, 7))
  }
  TC_RECORD(64 + 29, waited)
}

// A consumer warp's release of the ring buffer whose empty barrier is `bar`:
// its own block's, or every block's of the cluster.
template <bool CLUSTER>
__device__ __forceinline__ void release_wide(uint32_t bar, int blocks, bool on) {
  if constexpr (CLUSTER) {
    mbar_arrive_cluster(bar, blocks, on);
  } else {
    mbar_arrive(bar, on);
  }
}

// Runs the member's chain on the input staged in buffer 0 of `act` (the
// block's scratch). Hidden layers write the next product's input into the
// other buffer, fence it and arrive on the ready barrier; the head leaves
// (TC_ROWS, head_ld) f32 at `head`, bias added. Ends with a consumer barrier.
//
// CLUSTER: the block is one of `blocks` in a cluster; each consumer warp
// releases a ring buffer on the empty barrier of every block of the cluster
// (any of them may have multicast into it).
template <int ACT, bool BF16, bool CLUSTER = false>
__device__ void consume_wide(const WideDesc& d, const int* __restrict__ dims, unsigned char* smem,
                             unsigned char* act, float* head, const float* __restrict__ bias,
                             uint32_t& it, int blocks = 1) {
  using C = TC<BF16>;
  const uint32_t bars = smem_u32(smem);
  const uint32_t stage0 = bars + WT_BARRIER_BYTES;
  const int lane = threadIdx.x & 31;
  const int wg = uniform(threadIdx.x >> 7);  // this warpgroup's half of each pass
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float acc[ACC_REGS];
  int b_off = 0;
  for (int i = 0; i < d.num_products; ++i) {
    const bool hidden = i + 1 < d.num_products;
    const int dout = uniform(__ldg(dims + i + 1));
    const int kp = wt_round_up(uniform(__ldg(dims + i)), C::KSTEP);
    const int np = wt_round_up(dout, hidden ? C::KSTEP : 8);
    unsigned char* dst = act + ((i + 1) & 1) * d.a_buf_bytes;
    for (int p0 = 0; p0 < np; p0 += WT_PASS) {
      const int npass = min(WT_PASS, np - p0);
      const int half = (npass / 8 + 1) / 2;  // warpgroup 0's 8-column groups
      const int n8 = wg ? npass / 8 - half : half, nw = wg ? 8 * half : 0;
      const uint32_t b_lbo = npass * 16;
      // this thread's biases, loaded now so that the loads overlap the products
      float bia[ACC_REGS / 2];
#pragma unroll
      for (int j = 0; j < ACC_REGS / 4; ++j) {
        const int c = p0 + nw + 2 * (lane & 3) + 8 * j;
        bia[2 * j] = j < n8 && c < dout ? __ldg(bias + b_off + c) : 0.0f;
        bia[2 * j + 1] = j < n8 && c + 1 < dout ? __ldg(bias + b_off + c + 1) : 0.0f;
      }
      int prev = -1;  // the previous chunk's buffer, freed once its products are done
      for (int k0 = 0; k0 < kp; k0 += C::CHUNK) {
        const int kc = min(C::CHUNK, kp - k0);
        const int s = it % d.stages;
        mbar_wait(bars + 8 * s, (it / d.stages) & 1);
        TC_STAMP_IF(3 + 3 * min(i, 7), p0 == 0 && k0 == 0)
        const uint32_t a = stage0 + s * d.stage_bytes;
        const uint32_t b = a + wt_a_slot<BF16>() + nw * 16;
        issue<BF16>(kc / C::KSTEP, n8, k0 == 0, acc, a, a + TC_ROWS * kc * C::ESIZE, b,
                    b + kc * npass * C::ESIZE, b_lbo);
        wgmma_wait<1>();
        if (prev >= 0) release_wide<CLUSTER>(bars + 64 + 8 * prev, blocks, lane == 0);
        prev = s;
        ++it;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      TC_STAMP_IF(4 + 3 * min(i, 7), p0 + WT_PASS >= np)
      release_wide<CLUSTER>(bars + 64 + 8 * prev, blocks, lane == 0);
      const int n0 = p0 + nw;
      if (hidden) {
        for_each_acc(acc, n8, n0, [&](int j, float v00, float v01, float v10, float v11, int c) {
          const bool in0 = c < dout, in1 = c + 1 < dout;
          const float b0 = bia[2 * j], b1 = bia[2 * j + 1];
          store_wide_a2<BF16>(dst, np, r, c, in0 ? tc_activate<ACT>(v00 + b0) : 0.0f,
                              in1 ? tc_activate<ACT>(v01 + b1) : 0.0f);
          store_wide_a2<BF16>(dst, np, r + 8, c, in0 ? tc_activate<ACT>(v10 + b0) : 0.0f,
                              in1 ? tc_activate<ACT>(v11 + b1) : 0.0f);
        });
      } else {
        for_each_acc(acc, n8, n0, [&](int j, float v00, float v01, float v10, float v11, int c) {
          const float b0 = bia[2 * j], b1 = bia[2 * j + 1];
          *reinterpret_cast<float2*>(head + r * d.head_ld + c) = make_float2(v00 + b0, v01 + b1);
          *reinterpret_cast<float2*>(head + (r + 8) * d.head_ld + c) =
              make_float2(v10 + b0, v11 + b1);
        });
      }
    }
    b_off += dout;
    if (hidden) {  // the next product's input is written: hand it to the producer
      fence_proxy_async_global();
      mbar_arrive(bars + WT_READY, true);
      TC_STAMP(5 + 3 * min(i, 7))
    }
  }
  consumer_sync();  // the head is whole
  TC_STAMP(5 + 3 * min(d.num_products - 1, 7))
}

// ---------------------------------------------------------------------------
// Activations resident in shared memory (K1 and K2 in bf16, wide_smem.cu).
// A bf16 tile's two activation buffers (64 x kmax each) stay in the block's
// shared memory after the barriers, beside a ring that carries weight chunks
// only. A product's epilogue writes the next one's A operand there; a proxy
// fence and a consumer barrier hand it on. Nothing makes a round trip
// through device memory between products, and the producer, which no
// longer waits for activations, runs ahead across products (and K1's steps).

// the chain's input (TC_ROWS, din) into the resident buffer 0, value(r, c)
// for c < din and zero up to kp, made visible to wgmma
template <bool BF16, typename F>
__device__ __forceinline__ void stage_smem_input(unsigned char* buf, int din, F value) {
  using C = TC<BF16>;
  const int kp = wt_round_up(din, C::KSTEP);
  for (int idx = threadIdx.x; idx < TC_ROWS * kp; idx += TC_CONSUMERS) {
    const int cg = idx / (TC_ROWS * C::T), rem = idx - cg * (TC_ROWS * C::T);
    const int r = rem / C::T, c = cg * C::T + rem % C::T;
    store_wide_a<BF16>(buf, kp, r, c, c < din ? value(r, c) : 0.0f);
  }
  fence_proxy_async();
  consumer_sync();
}

// Streams the weight chunks of one chain of member `wm` through the ring
// (stage_bytes a weight chunk, after the resident buffers). Marks as
// produce_wide's, without the ready barrier.
template <bool BF16>
__device__ void produce_wide_smem(const WideDesc& d, const int* __restrict__ dims,
                                  unsigned char* smem, const unsigned char* wm, uint32_t& it) {
  using C = TC<BF16>;
  const uint32_t bars = smem_u32(smem);
  const uint32_t stage0 = bars + WT_BARRIER_BYTES + 2 * (uint32_t)d.a_buf_bytes;
  const unsigned char* src = wm;
  unsigned long long waited = 0;  // the timeline's: ns waited on empty barriers
  for (int i = 0; i < d.num_products; ++i) {
    const bool hidden = i + 1 < d.num_products;
    const int kp = wt_round_up(__ldg(dims + i), C::KSTEP);
    const int np = wt_round_up(__ldg(dims + i + 1), hidden ? C::KSTEP : 8);
    TC_STAMP(3 + 3 * min(i, 7))
    for (int p0 = 0; p0 < np; p0 += WT_PASS) {
      const int npass = min(WT_PASS, np - p0);
      for (int k0 = 0; k0 < kp; k0 += C::CHUNK) {
        const uint32_t b_bytes = min(C::CHUNK, kp - k0) * npass * C::ESIZE * C::COPIES;
        const int s = it % d.stages;
        wait_free(bars + 64 + 8 * s, ((it / d.stages) & 1) ^ 1, i == 1, waited);
        mbar_expect_tx(bars + 8 * s, b_bytes);
        bulk_load(stage0 + s * d.stage_bytes, src, b_bytes, bars + 8 * s);
        src += b_bytes;
        ++it;
      }
    }
    TC_STAMP(4 + 3 * min(i, 7))
  }
  TC_RECORD(64 + 29, waited)
}

// Runs the member's chain on the input staged in resident buffer 0, as
// consume_wide does, with A read from the resident buffers. The head leaves
// (TC_ROWS, head_ld) f32 at `head` (the block's scratch), bias added. Ends
// with a consumer barrier.
template <int ACT, bool BF16>
__device__ void consume_wide_smem(const WideDesc& d, const int* __restrict__ dims,
                                  unsigned char* smem, float* head,
                                  const float* __restrict__ bias, uint32_t& it) {
  using C = TC<BF16>;
  const uint32_t bars = smem_u32(smem);
  unsigned char* abuf = smem + WT_BARRIER_BYTES;
  const uint32_t a0 = bars + WT_BARRIER_BYTES;
  const uint32_t stage0 = a0 + 2 * (uint32_t)d.a_buf_bytes;
  const int lane = threadIdx.x & 31;
  const int wg = uniform(threadIdx.x >> 7);  // this warpgroup's half of each pass
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  float acc[ACC_REGS];
  int b_off = 0;
  for (int i = 0; i < d.num_products; ++i) {
    const bool hidden = i + 1 < d.num_products;
    const int dout = uniform(__ldg(dims + i + 1));
    const int kp = wt_round_up(uniform(__ldg(dims + i)), C::KSTEP);
    const int np = wt_round_up(dout, hidden ? C::KSTEP : 8);
    const uint32_t src = a0 + (i & 1) * (uint32_t)d.a_buf_bytes;
    unsigned char* dst = abuf + ((i + 1) & 1) * d.a_buf_bytes;
    for (int p0 = 0; p0 < np; p0 += WT_PASS) {
      const int npass = min(WT_PASS, np - p0);
      const int half = (npass / 8 + 1) / 2;  // warpgroup 0's 8-column groups
      const int n8 = wg ? npass / 8 - half : half, nw = wg ? 8 * half : 0;
      const uint32_t b_lbo = npass * 16;
      float bia[ACC_REGS / 2];
#pragma unroll
      for (int j = 0; j < ACC_REGS / 4; ++j) {
        const int c = p0 + nw + 2 * (lane & 3) + 8 * j;
        bia[2 * j] = j < n8 && c < dout ? __ldg(bias + b_off + c) : 0.0f;
        bia[2 * j + 1] = j < n8 && c + 1 < dout ? __ldg(bias + b_off + c + 1) : 0.0f;
      }
      int prev = -1;
      for (int k0 = 0; k0 < kp; k0 += C::CHUNK) {
        const int kc = min(C::CHUNK, kp - k0);
        const int s = it % d.stages;
        mbar_wait(bars + 8 * s, (it / d.stages) & 1);
        TC_STAMP_IF(3 + 3 * min(i, 7), p0 == 0 && k0 == 0)
        const uint32_t a = src + k0 * TC_ROWS * C::ESIZE * C::COPIES;
        const uint32_t b = stage0 + s * d.stage_bytes + nw * 16;
        issue<BF16>(kc / C::KSTEP, n8, k0 == 0, acc, a, a + TC_ROWS * kc * C::ESIZE, b,
                    b + kc * npass * C::ESIZE, b_lbo);
        wgmma_wait<1>();
        if (prev >= 0) mbar_arrive(bars + 64 + 8 * prev, lane == 0);
        prev = s;
        ++it;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      TC_STAMP_IF(4 + 3 * min(i, 7), p0 + WT_PASS >= np)
      mbar_arrive(bars + 64 + 8 * prev, lane == 0);
      const int n0 = p0 + nw;
      if (hidden) {
        for_each_acc(acc, n8, n0, [&](int j, float v00, float v01, float v10, float v11, int c) {
          const bool in0 = c < dout, in1 = c + 1 < dout;
          const float b0 = bia[2 * j], b1 = bia[2 * j + 1];
          store_wide_a2<BF16>(dst, np, r, c, in0 ? tc_activate<ACT>(v00 + b0) : 0.0f,
                              in1 ? tc_activate<ACT>(v01 + b1) : 0.0f);
          store_wide_a2<BF16>(dst, np, r + 8, c, in0 ? tc_activate<ACT>(v10 + b0) : 0.0f,
                              in1 ? tc_activate<ACT>(v11 + b1) : 0.0f);
        });
      } else {
        for_each_acc(acc, n8, n0, [&](int j, float v00, float v01, float v10, float v11, int c) {
          const float b0 = bia[2 * j], b1 = bia[2 * j + 1];
          *reinterpret_cast<float2*>(head + r * d.head_ld + c) = make_float2(v00 + b0, v01 + b1);
          *reinterpret_cast<float2*>(head + (r + 8) * d.head_ld + c) =
              make_float2(v10 + b0, v11 + b1);
        });
      }
    }
    b_off += dout;
    if (hidden) {  // the next product's input is written: hand it to wgmma
      fence_proxy_async();
      consumer_sync();
      TC_STAMP(5 + 3 * min(i, 7))
    }
  }
  consumer_sync();  // the head is whole
  TC_STAMP(5 + 3 * min(d.num_products - 1, 7))
}

// ---------------------------------------------------------------------------
// Host side

// The layout, the scratch and the shared-memory plan; false if a width is < 1
// or a buffer outgrows the int offsets. carry_floats: K1's obs carry and
// running return per row (obs_dim + 1), else 0.
template <bool BF16>
static bool make_wide_desc(const int* dims, int num_products, int carry_floats, WideDesc* d,
                           size_t* smem) {
  using C = TC<BF16>;
  if (num_products < 1) return false;
  for (int i = 0; i <= num_products; ++i)
    if (dims[i] < 1) return false;
  long long w = 0, b = 0;
  int kmax = 0, nmax = 0, np = 0;
  for (int i = 0; i < num_products; ++i) {
    const int kp = wt_round_up(dims[i], C::KSTEP);
    np = wt_round_up(dims[i + 1], i + 1 < num_products ? C::KSTEP : 8);
    w += (long long)kp * np * C::COPIES;
    b += dims[i + 1];
    kmax = kmax > kp ? kmax : kp;
    nmax = nmax > np ? nmax : np;
  }
  d->num_products = num_products;
  d->w_member = w;
  d->b_member = (int)b;
  d->a_buf_bytes = (long long)TC_ROWS * kmax * C::ESIZE * C::COPIES;
  d->head_off = 2 * d->a_buf_bytes;
  d->head_ld = np;
  d->carry_off = d->head_off + (long long)TC_ROWS * np * 4;
  d->block_bytes = (d->carry_off + 4LL * TC_ROWS * carry_floats + 127) / 128 * 128;
  if (b > INT_MAX || d->block_bytes > INT_MAX) return false;
  d->stage_bytes = wt_a_slot<BF16>() + C::CHUNK * (nmax < WT_PASS ? nmax : WT_PASS) * C::ESIZE * C::COPIES;
  const int stages = (TC_SMEM_LIMIT - WT_BARRIER_BYTES) / d->stage_bytes;
  d->stages = stages < TC_MAX_STAGES ? stages : TC_MAX_STAGES;
  if (d->stages < 2) return false;
  *smem = (size_t)WT_BARRIER_BYTES + (size_t)d->stages * d->stage_bytes;
  return true;
}

// The resident-activation plan (bf16 only): the scratch as make_wide_desc's
// (the head, K1's carry), shared memory the barriers, two resident
// activation buffers and a ring of weight chunks; false where fewer than
// WT_SMEM_MIN_STAGES ring buffers fit beside the buffers (a wider stack).
// Mirrors WideTileLayout.smem_stages in ops/kernels.py.
static bool make_smem_desc(const int* dims, int num_products, int carry_floats, WideDesc* d,
                           size_t* smem) {
  if (!make_wide_desc<true>(dims, num_products, carry_floats, d, smem)) return false;
  d->stage_bytes -= wt_a_slot<true>();  // weights only
  const long long free_bytes = TC_SMEM_LIMIT - WT_BARRIER_BYTES - 2 * d->a_buf_bytes;
  const long long stages = free_bytes > 0 ? free_bytes / d->stage_bytes : 0;
  d->stages = stages < TC_MAX_STAGES ? (int)stages : TC_MAX_STAGES;
  if (d->stages < WT_SMEM_MIN_STAGES) return false;
  *smem = (size_t)(WT_BARRIER_BYTES + 2 * d->a_buf_bytes) + (size_t)d->stages * d->stage_bytes;
  return true;
}

static bool make_wide_desc(bool bf16, const int* dims, int num_products, int carry_floats,
                           WideDesc* d, size_t* smem) {
  return bf16 ? make_wide_desc<true>(dims, num_products, carry_floats, d, smem)
              : make_wide_desc<false>(dims, num_products, carry_floats, d, smem);
}

// K3's resident plan (ensemble_mlp_wide_smem.cu): the weights as
// make_wide_desc's (pack_wide's tiles) and no scratch; shared memory the
// barriers, one activation buffer (TC_ROWS x kmax, one f32 or bf16 copy
// laid out by A fragment; in f32 at least a head split by K's (TC_ROWS, np)
// partial sums), a ring (a buffer holds wt_slice K rows of the widest
// product, in f32 at least one chunk of the widest one-pass product) and one
// product's biases (nmax f32). false where a product is wider than two
// passes (a warpgroup takes at most one) or fewer than WT_SMEM_MIN_STAGES
// ring buffers fit. Mirrors WideTileLayout.k3_stages in ops/kernels.py.
template <bool BF16>
static bool make_wide_smem_desc(const int* dims, int num_products, WideDesc* d, size_t* smem) {
  using C = TC<BF16>;
  if (!make_wide_desc<BF16>(dims, num_products, 0, d, smem)) return false;
  int kmax = 0, nmax = 0, n1max = 0, np = 0;
  for (int i = 0; i < num_products; ++i) {
    const int kp = wt_round_up(dims[i], C::KSTEP);
    np = wt_round_up(dims[i + 1], i + 1 < num_products ? C::KSTEP : 8);
    kmax = kmax > kp ? kmax : kp;
    nmax = nmax > np ? nmax : np;
    if (!BF16 && np <= WT_PASS) n1max = n1max > np ? n1max : np;
  }
  if (nmax > 2 * WT_PASS) return false;
  const long long a_bytes = (long long)TC_ROWS * kmax * C::ESIZE;
  const long long part_bytes = !BF16 && np <= TC_HEAD_SPLIT ? 4LL * TC_ROWS * np : 0;
  d->a_buf_bytes = a_bytes > part_bytes ? a_bytes : part_bytes;
  d->head_off = d->carry_off = d->block_bytes = 0;
  const int slice = wt_slice<BF16>() * nmax, chunk = C::CHUNK * n1max;
  d->stage_bytes = (slice > chunk ? slice : chunk) * C::ESIZE * C::COPIES;
  const long long free_bytes = TC_SMEM_LIMIT - WT_BARRIER_BYTES - d->a_buf_bytes - 4LL * nmax;
  const long long stages = free_bytes > 0 ? free_bytes / d->stage_bytes : 0;
  d->stages = stages < TC_MAX_STAGES ? (int)stages : TC_MAX_STAGES;
  if (d->stages < WT_SMEM_MIN_STAGES) return false;
  *smem = (size_t)(WT_BARRIER_BYTES + d->a_buf_bytes) + (size_t)d->stages * d->stage_bytes +
          4 * (size_t)nmax;
  return true;
}

static bool make_wide_smem_desc(bool bf16, const int* dims, int num_products, WideDesc* d,
                                size_t* smem) {
  return bf16 ? make_wide_smem_desc<true>(dims, num_products, d, smem)
              : make_wide_smem_desc<false>(dims, num_products, d, smem);
}
