// K1's and K2's wide route in bf16 with the activations resident in shared
// memory (sm_90a), written by hand: the WT_SMEM instantiations of
// rollout_returns_wide_tc_kernel and gaussian_wide_tc_kernel
// (wide_rollout.cuh; the plan make_smem_desc, the products
// consume_wide_smem, wide_tc.cuh), compiled here, by their own nvcc. The
// design and what it replaces are described at the top of wide_tc.cu, whose
// entries launch these where make_smem_desc takes the stack.

#include "wide_rollout.cuh"

#ifdef TC_TIMELINE
// The marks of the resident kernels' block (0, 0) (wide_tc.cuh), as
// mbrl_timeline_wide's of the plain ones.
extern "C" int mbrl_timeline_wide_smem(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
}
#endif

#define LAUNCH_K2SM(ACT, BF16, grid, smem, stream, args)                                  \
  {                                                                                       \
    cudaError_t err = prepare_once<gaussian_wide_tc_kernel<ACT, BF16, WT_SMEM>>();        \
    if (err != cudaSuccess) return err;                                                   \
    gaussian_wide_tc_kernel<ACT, BF16, WT_SMEM><<<grid, TC_THREADS, smem, stream>>>(args); \
    return cudaSuccess;                                                                   \
  }

#define LAUNCH_K1SM(ACT, BF16, grid, smem, stream, args)                                         \
  {                                                                                              \
    cudaError_t err = prepare_once<rollout_returns_wide_tc_kernel<ACT, BF16, WT_SMEM>>();        \
    if (err != cudaSuccess) return err;                                                          \
    rollout_returns_wide_tc_kernel<ACT, BF16, WT_SMEM><<<grid, TC_THREADS, smem, stream>>>(args); \
    return cudaSuccess;                                                                          \
  }

cudaError_t launch_k2_smem(int act, dim3 grid, size_t smem, cudaStream_t stream, const K2Args& a) {
  DISPATCH_ACT(act, true, LAUNCH_K2SM, grid, smem, stream, a)
  return cudaErrorInvalidValue;
}

cudaError_t launch_k1_smem(int act, dim3 grid, size_t smem, cudaStream_t stream, const K1Args& a) {
  DISPATCH_ACT(act, true, LAUNCH_K1SM, grid, smem, stream, a)
  return cudaErrorInvalidValue;
}
