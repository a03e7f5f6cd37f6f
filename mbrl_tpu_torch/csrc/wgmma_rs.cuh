// wgmma.mma_async wrappers with A from registers, for K3's two-tile route
// (ensemble_mlp.cu) and its resident wide route (ensemble_mlp_wide_smem.cu):
// a warpgroup takes up to 256 columns of a product in one instruction,
// N = 8, 16, ..., 256: bf16 m64nNk16 and tf32 m64nNk8, B read from shared
// memory through a descriptor (K-major); a[0..3] is the thread's A fragment
// (bf16: two values a register; tf32: one). d holds the N/2 f32 accumulators
// of the calling thread: the product is added to them when `add` is 1
// (scale-d), written over them when it is 0.
// PTX names the width in the opcode and lists every accumulator register, so
// each width is its own instruction; the operand lists are spelled out once
// below and each width is one line.
#pragma once
#include <stdint.h>

#include "tc_chain.cuh"

template <int N>
__device__ __forceinline__ void wgmma_bf16_rs(float* d, const uint32_t* a, uint64_t db, int add);
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t* a, uint64_t db, int add);

// "%0, ..., %(4j-1)": the accumulators of an N = 8j instruction
#define TC_RS_REGS1 "%0, %1, %2, %3"
#define TC_RS_REGS2 TC_RS_REGS1 ", %4, %5, %6, %7"
#define TC_RS_REGS3 TC_RS_REGS2 ", %8, %9, %10, %11"
#define TC_RS_REGS4 TC_RS_REGS3 ", %12, %13, %14, %15"
#define TC_RS_REGS5 TC_RS_REGS4 ", %16, %17, %18, %19"
#define TC_RS_REGS6 TC_RS_REGS5 ", %20, %21, %22, %23"
#define TC_RS_REGS7 TC_RS_REGS6 ", %24, %25, %26, %27"
#define TC_RS_REGS8 TC_RS_REGS7 ", %28, %29, %30, %31"
#define TC_RS_REGS9 TC_RS_REGS8 ", %32, %33, %34, %35"
#define TC_RS_REGS10 TC_RS_REGS9 ", %36, %37, %38, %39"
#define TC_RS_REGS11 TC_RS_REGS10 ", %40, %41, %42, %43"
#define TC_RS_REGS12 TC_RS_REGS11 ", %44, %45, %46, %47"
#define TC_RS_REGS13 TC_RS_REGS12 ", %48, %49, %50, %51"
#define TC_RS_REGS14 TC_RS_REGS13 ", %52, %53, %54, %55"
#define TC_RS_REGS15 TC_RS_REGS14 ", %56, %57, %58, %59"
#define TC_RS_REGS16 TC_RS_REGS15 ", %60, %61, %62, %63"
#define TC_RS_REGS17 TC_RS_REGS16 ", %64, %65, %66, %67"
#define TC_RS_REGS18 TC_RS_REGS17 ", %68, %69, %70, %71"
#define TC_RS_REGS19 TC_RS_REGS18 ", %72, %73, %74, %75"
#define TC_RS_REGS20 TC_RS_REGS19 ", %76, %77, %78, %79"
#define TC_RS_REGS21 TC_RS_REGS20 ", %80, %81, %82, %83"
#define TC_RS_REGS22 TC_RS_REGS21 ", %84, %85, %86, %87"
#define TC_RS_REGS23 TC_RS_REGS22 ", %88, %89, %90, %91"
#define TC_RS_REGS24 TC_RS_REGS23 ", %92, %93, %94, %95"
#define TC_RS_REGS25 TC_RS_REGS24 ", %96, %97, %98, %99"
#define TC_RS_REGS26 TC_RS_REGS25 ", %100, %101, %102, %103"
#define TC_RS_REGS27 TC_RS_REGS26 ", %104, %105, %106, %107"
#define TC_RS_REGS28 TC_RS_REGS27 ", %108, %109, %110, %111"
#define TC_RS_REGS29 TC_RS_REGS28 ", %112, %113, %114, %115"
#define TC_RS_REGS30 TC_RS_REGS29 ", %116, %117, %118, %119"
#define TC_RS_REGS31 TC_RS_REGS30 ", %120, %121, %122, %123"
#define TC_RS_REGS32 TC_RS_REGS31 ", %124, %125, %126, %127"

#define TC_RS_D4(o) "+f"(d[o]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3])
#define TC_RS_ACC1 TC_RS_D4(0)
#define TC_RS_ACC2 TC_RS_ACC1, TC_RS_D4(4)
#define TC_RS_ACC3 TC_RS_ACC2, TC_RS_D4(8)
#define TC_RS_ACC4 TC_RS_ACC3, TC_RS_D4(12)
#define TC_RS_ACC5 TC_RS_ACC4, TC_RS_D4(16)
#define TC_RS_ACC6 TC_RS_ACC5, TC_RS_D4(20)
#define TC_RS_ACC7 TC_RS_ACC6, TC_RS_D4(24)
#define TC_RS_ACC8 TC_RS_ACC7, TC_RS_D4(28)
#define TC_RS_ACC9 TC_RS_ACC8, TC_RS_D4(32)
#define TC_RS_ACC10 TC_RS_ACC9, TC_RS_D4(36)
#define TC_RS_ACC11 TC_RS_ACC10, TC_RS_D4(40)
#define TC_RS_ACC12 TC_RS_ACC11, TC_RS_D4(44)
#define TC_RS_ACC13 TC_RS_ACC12, TC_RS_D4(48)
#define TC_RS_ACC14 TC_RS_ACC13, TC_RS_D4(52)
#define TC_RS_ACC15 TC_RS_ACC14, TC_RS_D4(56)
#define TC_RS_ACC16 TC_RS_ACC15, TC_RS_D4(60)
#define TC_RS_ACC17 TC_RS_ACC16, TC_RS_D4(64)
#define TC_RS_ACC18 TC_RS_ACC17, TC_RS_D4(68)
#define TC_RS_ACC19 TC_RS_ACC18, TC_RS_D4(72)
#define TC_RS_ACC20 TC_RS_ACC19, TC_RS_D4(76)
#define TC_RS_ACC21 TC_RS_ACC20, TC_RS_D4(80)
#define TC_RS_ACC22 TC_RS_ACC21, TC_RS_D4(84)
#define TC_RS_ACC23 TC_RS_ACC22, TC_RS_D4(88)
#define TC_RS_ACC24 TC_RS_ACC23, TC_RS_D4(92)
#define TC_RS_ACC25 TC_RS_ACC24, TC_RS_D4(96)
#define TC_RS_ACC26 TC_RS_ACC25, TC_RS_D4(100)
#define TC_RS_ACC27 TC_RS_ACC26, TC_RS_D4(104)
#define TC_RS_ACC28 TC_RS_ACC27, TC_RS_D4(108)
#define TC_RS_ACC29 TC_RS_ACC28, TC_RS_D4(112)
#define TC_RS_ACC30 TC_RS_ACC29, TC_RS_D4(116)
#define TC_RS_ACC31 TC_RS_ACC30, TC_RS_D4(120)
#define TC_RS_ACC32 TC_RS_ACC31, TC_RS_D4(124)

// J = N / 8; A_B: the A fragment's and B descriptor's operands, P: add's
#define TC_RS_WIDTH(J, N, A_B, P)                                                        \
  template <>                                                                            \
  __device__ __forceinline__ void wgmma_bf16_rs<N>(float* d, const uint32_t* a, uint64_t db, \
                                                   int add) {                            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" TC_RS_REGS##J \
                 "}, " A_B ", p, 1, 1, 0;\n}\n"                                          \
                 : TC_RS_ACC##J                                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add)         \
                 : "memory");                                                            \
  }                                                                                      \
  template <>                                                                            \
  __device__ __forceinline__ void wgmma_tf32_rs<N>(float* d, const uint32_t* a, uint64_t db, \
                                                   int add) {                            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n"                          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" TC_RS_REGS##J  \
                 "}, " A_B ", p, 1, 1;\n}\n"                                             \
                 : TC_RS_ACC##J                                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add)         \
                 : "memory");                                                            \
  }

TC_RS_WIDTH(1, 8, "{%4, %5, %6, %7}, %8", "%9")
TC_RS_WIDTH(2, 16, "{%8, %9, %10, %11}, %12", "%13")
TC_RS_WIDTH(3, 24, "{%12, %13, %14, %15}, %16", "%17")
TC_RS_WIDTH(4, 32, "{%16, %17, %18, %19}, %20", "%21")
TC_RS_WIDTH(5, 40, "{%20, %21, %22, %23}, %24", "%25")
TC_RS_WIDTH(6, 48, "{%24, %25, %26, %27}, %28", "%29")
TC_RS_WIDTH(7, 56, "{%28, %29, %30, %31}, %32", "%33")
TC_RS_WIDTH(8, 64, "{%32, %33, %34, %35}, %36", "%37")
TC_RS_WIDTH(9, 72, "{%36, %37, %38, %39}, %40", "%41")
TC_RS_WIDTH(10, 80, "{%40, %41, %42, %43}, %44", "%45")
TC_RS_WIDTH(11, 88, "{%44, %45, %46, %47}, %48", "%49")
TC_RS_WIDTH(12, 96, "{%48, %49, %50, %51}, %52", "%53")
TC_RS_WIDTH(13, 104, "{%52, %53, %54, %55}, %56", "%57")
TC_RS_WIDTH(14, 112, "{%56, %57, %58, %59}, %60", "%61")
TC_RS_WIDTH(15, 120, "{%60, %61, %62, %63}, %64", "%65")
TC_RS_WIDTH(16, 128, "{%64, %65, %66, %67}, %68", "%69")
TC_RS_WIDTH(17, 136, "{%68, %69, %70, %71}, %72", "%73")
TC_RS_WIDTH(18, 144, "{%72, %73, %74, %75}, %76", "%77")
TC_RS_WIDTH(19, 152, "{%76, %77, %78, %79}, %80", "%81")
TC_RS_WIDTH(20, 160, "{%80, %81, %82, %83}, %84", "%85")
TC_RS_WIDTH(21, 168, "{%84, %85, %86, %87}, %88", "%89")
TC_RS_WIDTH(22, 176, "{%88, %89, %90, %91}, %92", "%93")
TC_RS_WIDTH(23, 184, "{%92, %93, %94, %95}, %96", "%97")
TC_RS_WIDTH(24, 192, "{%96, %97, %98, %99}, %100", "%101")
TC_RS_WIDTH(25, 200, "{%100, %101, %102, %103}, %104", "%105")
TC_RS_WIDTH(26, 208, "{%104, %105, %106, %107}, %108", "%109")
TC_RS_WIDTH(27, 216, "{%108, %109, %110, %111}, %112", "%113")
TC_RS_WIDTH(28, 224, "{%112, %113, %114, %115}, %116", "%117")
TC_RS_WIDTH(29, 232, "{%116, %117, %118, %119}, %120", "%121")
TC_RS_WIDTH(30, 240, "{%120, %121, %122, %123}, %124", "%125")
TC_RS_WIDTH(31, 248, "{%124, %125, %126, %127}, %128", "%129")
TC_RS_WIDTH(32, 256, "{%128, %129, %130, %131}, %132", "%133")

#undef TC_RS_WIDTH

// ---------------------------------------------------------------------------
// A resident in shared memory as one f32 (or bf16) copy laid out by A
// fragment, PAIR_SLOT_BYTES a k-step of 64 rows, loaded into registers before
// each k-step's wgmma; and the k-step's products on it.

#define PAIR_SLOT_BYTES 2048  // one k-step of a 64-row A: 4 warps x 32 lanes x 16 bytes

// Byte offset of lane `lane`'s A fragment for k-step q in warp `warp`'s part
// of a warpgroup's A region: 16 bytes a lane, lanes 8-15 and 24-31 swizzled
// by two slots, so that the f32 route's 8-byte reads of its neighbours'
// slots (pair_fragment) and the 16-byte stores hit no bank twice.
__device__ __forceinline__ int pair_slot(int q, int warp, int lane) {
  return ((q * 4 + warp) * 32 + (lane ^ ((lane >> 2) & 2))) * 16;
}

// This thread's A fragment of k-step q from its warpgroup's region `a`. bf16:
// four registers of two values, stored as the fragment itself. f32: the
// values are stored as the wgmma D fragment leaves them, (r, 2u), (r + 8, 2u),
// (r, 2u + 1), (r + 8, 2u + 1) in lane 4g + u; lane 4g + t takes columns t and
// t + 4 from lanes 4g + t/2 and 4g + 2 + t/2, and splits them into tf32 hi
// (f[0..3]) and lo (f[4..7]).
template <bool BF16>
__device__ __forceinline__ void pair_fragment(uint32_t* f, const unsigned char* a, int q, int warp,
                                              int lane) {
  if constexpr (BF16) {
    const uint4 v = *reinterpret_cast<const uint4*>(a + pair_slot(q, warp, lane));
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    const int t = lane & 3, g4 = lane & ~3, half = (t & 1) * 8;
    const float2 p = *reinterpret_cast<const float2*>(a + pair_slot(q, warp, g4 + (t >> 1)) + half);
    const float2 r =
        *reinterpret_cast<const float2*>(a + pair_slot(q, warp, g4 + 2 + (t >> 1)) + half);
    const float v[4] = {p.x, p.y, r.x, r.y};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float hi = to_tf32(v[k]);
      f[k] = __float_as_uint(hi);
      f[4 + k] = __float_as_uint(to_tf32(v[k] - hi));
    }
  }
}

// Stores a (2-row, 8-column) piece of this thread's A for the next product:
// values (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1) of column group j, c =
// 8j + 2t, in the layout pair_fragment reads. bf16 pairs two groups into one
// fragment: the caller passes both (v[0..3] group 2q, v[4..7] group 2q + 1).
template <bool BF16>
__device__ __forceinline__ void pair_store(unsigned char* a, int q, int warp, int lane,
                                           const float* v) {
  if constexpr (BF16) {
    const __nv_bfloat162 f0 = __floats2bfloat162_rn(v[0], v[1]), f1 = __floats2bfloat162_rn(v[2], v[3]);
    const __nv_bfloat162 f2 = __floats2bfloat162_rn(v[4], v[5]), f3 = __floats2bfloat162_rn(v[6], v[7]);
    *reinterpret_cast<uint4*>(a + pair_slot(q, warp, lane)) =
        make_uint4(*reinterpret_cast<const uint32_t*>(&f0), *reinterpret_cast<const uint32_t*>(&f1),
                   *reinterpret_cast<const uint32_t*>(&f2), *reinterpret_cast<const uint32_t*>(&f3));
  } else {
    *reinterpret_cast<float4*>(a + pair_slot(q, warp, lane)) = make_float4(v[0], v[2], v[1], v[3]);
  }
}

// One k-step's products for one warpgroup over the full N, as one commit
// group: fence, the products on the fragment `f`, commit. 3xTF32 for f32,
// the small cross terms first, as issue_chunk.
template <int N, bool BF16>
__device__ __forceinline__ void pair_issue(int first, float* acc, const uint32_t* f, uint32_t b,
                                           uint32_t b_lo, uint32_t b_lbo) {
  wgmma_fence();
  const uint64_t db = smem_desc(b, b_lbo, 128);
  if constexpr (BF16) {
    wgmma_bf16_rs<N>(acc, f, db, !first);
  } else {
    const uint64_t db_lo = smem_desc(b_lo, b_lbo, 128);
    wgmma_tf32_rs<N>(acc, f + 4, db, !first);
    wgmma_tf32_rs<N>(acc, f, db_lo, 1);
    wgmma_tf32_rs<N>(acc, f, db, 1);
  }
  wgmma_commit();
}

// k-step q: its fragment into `f` (held until the group is done), then its
// products at the width of this product (a compile-time case). ptxas
// pipelines register-A wgmma only so: with the fragment loaded inside each
// case, or a chunk's 2 (f32) or 4 (bf16) k-steps in one group, it
// serialized every wgmma of the kernel (C7511).
template <bool BF16>
__device__ __forceinline__ void pair_step(int n8, int first, float* acc, uint32_t* f,
                                          const unsigned char* a, int q, int warp, int lane,
                                          uint32_t b, uint32_t b_lo, uint32_t b_lbo) {
  pair_fragment<BF16>(f, a, q, warp, lane);
  switch (n8) {
#define PAIR_CASE(J)                                                   \
  case J:                                                              \
    pair_issue<8 * J, BF16>(first, acc, f, b, b_lo, b_lbo);            \
    break;
    PAIR_CASE(1) PAIR_CASE(2) PAIR_CASE(3) PAIR_CASE(4) PAIR_CASE(5) PAIR_CASE(6) PAIR_CASE(7)
    PAIR_CASE(8) PAIR_CASE(9) PAIR_CASE(10) PAIR_CASE(11) PAIR_CASE(12) PAIR_CASE(13)
    PAIR_CASE(14) PAIR_CASE(15) PAIR_CASE(16) PAIR_CASE(17) PAIR_CASE(18) PAIR_CASE(19)
    PAIR_CASE(20) PAIR_CASE(21) PAIR_CASE(22) PAIR_CASE(23) PAIR_CASE(24) PAIR_CASE(25)
    PAIR_CASE(26) PAIR_CASE(27) PAIR_CASE(28) PAIR_CASE(29) PAIR_CASE(30) PAIR_CASE(31)
    PAIR_CASE(32)
#undef PAIR_CASE
    default:
      wgmma_commit();
  }
}

// The bias (`bias`: this warpgroup's copy in shared memory) and activation of
// a hidden product's n8 column groups, stored as
// the next product's A (zero past dout, so the padded k-steps add nothing).
template <int ACT, bool BF16>
__device__ __forceinline__ void pair_epilogue(const float* acc, const float* bias, int n8, int dout,
                                              unsigned char* a, int warp, int lane) {
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < ACC_REGS / 2; j += BF16 ? 2 : 1) {
    if (j < n8) {
      float v[8];
#pragma unroll
      for (int h = 0; h < (BF16 ? 2 : 1); ++h) {
        const int c = c0 + 8 * (j + h);
        const bool in0 = c < dout, in1 = c + 1 < dout;
        const float b0 = in0 ? bias[c] : 0.0f, b1 = in1 ? bias[c + 1] : 0.0f;
        v[4 * h] = in0 ? tc_activate<ACT>(acc[4 * (j + h)] + b0) : 0.0f;
        v[4 * h + 1] = in1 ? tc_activate<ACT>(acc[4 * (j + h) + 1] + b1) : 0.0f;
        v[4 * h + 2] = in0 ? tc_activate<ACT>(acc[4 * (j + h) + 2] + b0) : 0.0f;
        v[4 * h + 3] = in1 ? tc_activate<ACT>(acc[4 * (j + h) + 3] + b1) : 0.0f;
      }
      pair_store<BF16>(a, BF16 ? j / 2 : j, warp, lane, v);
    }
  }
}

template <bool BF16>
__device__ __forceinline__ void pair_epilogue(int act, const float* acc, const float* bias, int n8,
                                              int dout, unsigned char* a, int warp, int lane) {
  switch (act) {
#define PAIR_ACT(A)                                                  \
  case A:                                                            \
    pair_epilogue<A, BF16>(acc, bias, n8, dout, a, warp, lane);      \
    break;
    PAIR_ACT(ACT_RELU) PAIR_ACT(ACT_SILU) PAIR_ACT(ACT_TANH) PAIR_ACT(ACT_ELU) PAIR_ACT(ACT_GELU)
    PAIR_ACT(ACT_LEAKY_RELU)
#undef PAIR_ACT
  }
}
