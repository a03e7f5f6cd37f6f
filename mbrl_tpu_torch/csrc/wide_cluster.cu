// K1's and K2's wide route in clusters of blocks that share each weight
// chunk (sm_90a), written by hand: the WT_CLUSTER instantiations of
// rollout_returns_wide_tc_kernel and gaussian_wide_tc_kernel
// (wide_rollout.cuh), compiled here, by their own nvcc beside wide_tc.cu's.
// The design and what it replaces are described at the top of wide_tc.cu;
// its entries launch these through launch_k2_cluster and launch_k1_cluster
// when the caller asks for clusters of more than one block.

#include "wide_rollout.cuh"

#ifdef TC_TIMELINE
// The marks of the cluster kernels' block (0, 0) (wide_tc.cuh), as
// mbrl_timeline_wide's of the plain ones.
extern "C" int mbrl_timeline_wide_cluster(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, tc_timeline, sizeof(tc_timeline));
}
#endif

static cudaLaunchAttribute cluster_attr(int cluster) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// KERNEL in clusters of `cluster` blocks along x
template <auto KERNEL, typename Args>
static cudaError_t launch_clusters(dim3 grid, int cluster, size_t smem, cudaStream_t stream,
                                   const Args& a) {
  cudaError_t err = prepare_once<KERNEL>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1] = {cluster_attr(cluster)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, KERNEL, a);
}

// the clusters of `cluster` blocks of KERNEL the card holds at once
template <auto KERNEL>
static cudaError_t max_clusters(size_t smem, int cluster, int* count) {
  cudaError_t err = prepare_once<KERNEL>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1] = {cluster_attr(cluster)};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, KERNEL, &cfg);
}

#define LAUNCH_K2CL(ACT, BF16, ...)                                                         \
  {                                                                                         \
    return launch_clusters<gaussian_wide_tc_kernel<ACT, BF16, WT_CLUSTER>>(__VA_ARGS__);    \
  }

#define LAUNCH_K1CL(ACT, BF16, ...)                                                             \
  {                                                                                             \
    return launch_clusters<rollout_returns_wide_tc_kernel<ACT, BF16, WT_CLUSTER>>(__VA_ARGS__); \
  }

#define MAX_CLUSTERS(ACT, BF16, k1, ...)                                                     \
  {                                                                                          \
    return k1 ? max_clusters<rollout_returns_wide_tc_kernel<ACT, BF16, WT_CLUSTER>>(__VA_ARGS__) \
              : max_clusters<gaussian_wide_tc_kernel<ACT, BF16, WT_CLUSTER>>(__VA_ARGS__);   \
  }

cudaError_t launch_k2_cluster(int act, int bf16, dim3 grid, int cluster, size_t smem,
                              cudaStream_t stream, const K2Args& a) {
  DISPATCH(act, bf16, LAUNCH_K2CL, grid, cluster, smem, stream, a)
  return cudaErrorInvalidValue;
}

cudaError_t launch_k1_cluster(int act, int bf16, dim3 grid, int cluster, size_t smem,
                              cudaStream_t stream, const K1Args& a) {
  DISPATCH(act, bf16, LAUNCH_K1CL, grid, cluster, smem, stream, a)
  return cudaErrorInvalidValue;
}

cudaError_t max_active_clusters(int k1, int act, int bf16, size_t smem, int cluster, int* count) {
  DISPATCH(act, bf16, MAX_CLUSTERS, k1, smem, cluster, count)
  return cudaErrorInvalidValue;
}
