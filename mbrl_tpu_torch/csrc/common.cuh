// What the kernel sources share: the activations, the launch dispatch on
// (activation, dtype) and the shared-memory attribute.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PRODUCTS 9  // up to 8 hidden layers + the head

enum Activation {
  ACT_RELU = 0,
  ACT_SILU = 1,
  ACT_TANH = 2,
  ACT_ELU = 3,
  ACT_GELU = 4,
  ACT_LEAKY_RELU = 5,
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

template <typename Kernel>
static cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
