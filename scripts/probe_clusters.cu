// What the card gives a kernel built on thread block clusters or on a
// cooperative grid: how many clusters of 8 and of 16 CTAs it keeps resident
// at a given shared-memory request, and what one cluster.sync(), one
// grid.sync() and a round of distributed-shared-memory reads cost.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -rdc=true \
//        -o probe_clusters scripts/probe_clusters.cu && ./probe_clusters
//
// Prints one line per measurement.  Kernel B1 (csrc/ista.cu) chose its
// cluster sizes from these numbers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cg = cooperative_groups;

#define CHECK(call)                                                        \
  do {                                                                     \
    cudaError_t e_ = (call);                                               \
    if (e_ != cudaSuccess) {                                               \
      std::printf("%s -> %s\n", #call, cudaGetErrorString(e_));            \
      return 1;                                                            \
    }                                                                      \
  } while (0)

__global__ void cluster_sync_loop(int n, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  smem[threadIdx.x] = (float)cluster.block_rank();
  cluster.sync();
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    cluster.sync();
    acc += smem[threadIdx.x];
  }
  if (out && threadIdx.x == 0) out[blockIdx.x] = acc;
}

// Each iteration every thread reads one float4 from each peer (fixed order),
// then two cluster syncs: the exchange pattern of kernel B1's reduction.
__global__ void cluster_exchange_loop(int n, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  const int C = cluster.num_blocks();
  for (int i = threadIdx.x; i < 4608; i += blockDim.x) smem[i] = (float)i;
  cluster.sync();
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    if (threadIdx.x < 90) {
      for (int c = 0; c < C; ++c) {
        const float4* peer = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(smem, c));
        const float4 v = peer[threadIdx.x + (i & 7) * 96];
        acc += v.x + v.y + v.z + v.w;
      }
    }
    cluster.sync();
    cluster.sync();
  }
  if (out && threadIdx.x == 0) out[blockIdx.x] = acc;
}

__global__ void grid_sync_loop(int n, float* out) {
  cg::grid_group grid = cg::this_grid();
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    grid.sync();
    acc += 1.f;
  }
  if (out && threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <typename K>
static int time_cluster(const char* name, K kernel, int csize, int nclusters,
                        int smem, int n, float* out) {
  CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * nclusters);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = -1;
  CHECK(cudaOccupancyMaxActiveClusters(&active, kernel, &cfg));
  cudaEvent_t a, b;
  CHECK(cudaEventCreate(&a));
  CHECK(cudaEventCreate(&b));
  CHECK(cudaLaunchKernelEx(&cfg, kernel, 10, out));  // warm-up
  CHECK(cudaDeviceSynchronize());
  CHECK(cudaEventRecord(a));
  CHECK(cudaLaunchKernelEx(&cfg, kernel, n, out));
  CHECK(cudaEventRecord(b));
  CHECK(cudaDeviceSynchronize());
  float ms = 0.f;
  CHECK(cudaEventElapsedTime(&ms, a, b));
  std::printf("%s: cluster %2d, %3d clusters, smem %6d B: max active clusters %d, "
              "%d iterations %.4f ms, %.3f us per iteration\n",
              name, csize, nclusters, smem, active, n, ms, ms * 1e3 / n);
  return 0;
}

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("%s: %d SMs, %zu B shared memory per block (opt-in), clock %d kHz\n",
              prop.name, prop.multiProcessorCount, prop.sharedMemPerBlockOptin,
              prop.clockRate);
  float* out;
  CHECK(cudaMalloc(&out, 4096 * sizeof(float)));
  const int n = 2000;
  const int smems[] = {32768, 180000, 215000, 232448};
  for (int smem : smems) {
    for (int csize : {8, 16}) {
      const int wave = 128 / csize;
      if (time_cluster("cluster.sync", cluster_sync_loop, csize, wave, smem, n, out)) return 1;
    }
  }
  for (int csize : {8, 16}) {
    if (time_cluster("exchange+2 syncs", cluster_exchange_loop, csize, 128 / csize, 215000, n, out)) return 1;
    // twice as many clusters as fit at once: the second wave waits for the first
    if (time_cluster("exchange+2 syncs", cluster_exchange_loop, csize, 256 / csize, 215000, n, out)) return 1;
  }

  {
    int nblocks = prop.multiProcessorCount;
    int nn = n;
    void* args[] = {&nn, &out};
    cudaEvent_t a, b;
    CHECK(cudaEventCreate(&a));
    CHECK(cudaEventCreate(&b));
    CHECK(cudaLaunchCooperativeKernel((void*)grid_sync_loop, dim3(nblocks), dim3(256), args, 0, 0));
    CHECK(cudaDeviceSynchronize());
    CHECK(cudaEventRecord(a));
    CHECK(cudaLaunchCooperativeKernel((void*)grid_sync_loop, dim3(nblocks), dim3(256), args, 0, 0));
    CHECK(cudaEventRecord(b));
    CHECK(cudaDeviceSynchronize());
    float ms = 0.f;
    CHECK(cudaEventElapsedTime(&ms, a, b));
    std::printf("grid.sync: %d blocks of 256 threads: %d iterations %.4f ms, %.3f us per sync\n",
                nblocks, n, ms, ms * 1e3 / n);
  }
  return 0;
}
