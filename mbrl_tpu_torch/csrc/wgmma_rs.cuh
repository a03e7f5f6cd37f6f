// wgmma.mma_async wrappers with A from registers, for K3's two-tile route
// (ensemble_mlp.cu): one warpgroup takes a whole tile, so each product is one
// instruction of the layer's full width, N = 8, 16, ..., 256. bf16 m64nNk16
// and tf32 m64nNk8, B read from shared memory through a descriptor
// (K-major); a[0..3] is the thread's A fragment (bf16: two values a
// register; tf32: one). d holds the N/2 f32 accumulators of the calling
// thread: the product is added to them when `add` is 1 (scale-d), written over
// them when it is 0.
// PTX names the width in the opcode and lists every accumulator register, so
// each width is its own instruction; the operand lists are spelled out once
// below and each width is one line.
#pragma once
#include <stdint.h>

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
