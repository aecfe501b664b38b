// What a warp's 16-byte shared-memory load costs on this card, by how many
// distinct addresses its 32 lanes read: the question behind kernel B1's
// register tiles (csrc/ista.cu), whose operand loads are partly broadcasts.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o probe_smem_loads scripts/probe_smem_loads.cu
//   ./probe_smem_loads
//
// One CTA of 256 threads per SM on every SM; each thread issues 4096
// LDS.128 (independent, summed) at the address its mode gives, and the
// kernel reports clock cycles per warp-load per SM (all 8 warps' loads over
// the CTA's cycles), beside 32-bit shuffles.
#include <cstdio>
#include <cuda_runtime.h>

constexpr int kIters = 4096;

__global__ void __launch_bounds__(256) loads(int mode, float* out, long long* cycles) {
  __shared__ float4 buf[2048];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < 2048; i += 256) buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  int idx;
  switch (mode) {
    case 0: idx = 0; break;                                   // 1 distinct address per warp
    case 1: idx = ((lane >> 2) & 1) * 129 + (lane >> 4) * 2; break;  // 2 per quarter-warp, 4 per warp
    case 2: idx = ((lane >> 2) & 3) * 129 + (lane >> 4) * 2; break;  // 2 per quarter, 8 per warp
    case 3: idx = (lane & 3) * 129 + (lane >> 4) * 2; break;  // 4 per quarter, 8 per warp
    case 4: idx = (lane & 7) * 129; break;                    // 8 per quarter, 8 per warp
    default: idx = lane; break;                               // 32 consecutive
  }
  float4 acc = make_float4(0, 0, 0, 0);
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  const long long t0 = clock64();
  if (mode < 6) {
    // ld.shared in inline PTX, so that no load is merged or hoisted
#pragma unroll 16
    for (int i = 0; i < kIters; ++i) {
      float4 v;
      const unsigned addr = base + 16u * ((idx + (i & 7) * 256) & 2047);
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  } else {
    // four independent chains, so that throughput and not latency shows
    float v0 = tid, v1 = tid + 1, v2 = tid + 2, v3 = tid + 3;
#pragma unroll 16
    for (int i = 0; i < kIters; i += 4) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
      v2 += __shfl_xor_sync(0xffffffffu, v2, 4);
      v3 += __shfl_xor_sync(0xffffffffu, v3, 8);
    }
    acc.x = v0 + v1 + v2 + v3;
  }
  __syncthreads();
  const long long t1 = clock64();
  if (tid == 0) cycles[blockIdx.x] = t1 - t0;
  out[blockIdx.x * 256 + tid] = acc.x + acc.y + acc.z + acc.w;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  long long* cycles;
  cudaMalloc(&out, sms * 256 * sizeof(float));
  cudaMallocManaged(&cycles, sms * sizeof(long long));
  const char* names[] = {"1 address per warp", "4 per warp (2 per quarter)", "8 per warp (2 per quarter)",
                         "8 per warp (4 per quarter)", "8 per warp (8 per quarter)", "32 consecutive",
                         "32-bit shuffle"};
  for (int mode = 0; mode < 7; ++mode) {
    loads<<<sms, 256>>>(mode, out, cycles);
    loads<<<sms, 256>>>(mode, out, cycles);
    if (cudaDeviceSynchronize() != cudaSuccess) { printf("launch failed\n"); return 1; }
    double mean = 0;
    for (int i = 0; i < sms; ++i) mean += cycles[i];
    mean /= sms;
    printf("%-28s %6.2f cycles per warp instruction per SM (8 warps x %d each)\n", names[mode],
           mean / (8.0 * kIters), kIters);
  }
  return 0;
}
