// The spectral norms of a group of convolution weights by power iteration,
// all in one launch, for Hopper.
//
// Replaces no TPU kernel: the JAX package leaves the power iteration of
// lrs_pnp_dip_tpu/models/lipschitz.py:_sigma_max_power to XLA, which fuses
// it.  On the card the plain version (lrs_pnp_dip_tpu_torch/models/
// lipschitz.py:_sigma_max_power) runs each step as a few library kernels:
// about 70 latency-bound launches a convolution, some 1,000 a forward of the
// 1-Lip U-Net (14 spectrally normalised convolutions), which took about half
// of the DIP fit's device time.  This kernel computes the same function for
// every convolution of a forward in one launch:
//
//   for n_iter steps:  v = W^T u;  v = v / (|v| + 1e-12)
//                      u = W v;    u = u / (|u| + 1e-12)
//   sigma = |W^T u|,   factor = max(1, sigma / ln_lambda)
//
// with W the weight viewed as (m, n) = (out, in k^2), row-major f32, and u
// the persistent vector of m floats, which the launch advances in place.
// The arithmetic is the plain version's, the same formula step for step;
// only the order of the sums differs.  Outputs: sigma and the factor of
// conv g at out[g] and out[G + g].
//
// Bound.  The 1-Lip U-Net's 14 weights hold 1,638,400 floats (6.55 MB), one
// read from device memory in 1.96 us at 3.35 TB/s; the 17 matrix-vector
// products of a conv are 55.7 MFLOP a forward, nothing.  What bounds it is
// latency: 2 n_iter + 1 dependent products, each ending in a reduction that
// every later step needs.
//
// Design.  One thread-block cluster of C CTAs per convolution, all of them
// in one grid.  W is split by columns (m <= n at every shape of the net:
// m = 128, n = 1152, 512 or 128): CTA c loads W[:, c seg : (c + 1) seg]
// into its shared memory once, and it stays there for every step and sigma.
// Each CTA keeps a copy of u.  A step:
//
//   1. v_c = W_c^T u for the CTA's columns (no sum crosses CTAs), and the
//      CTA's partial |v_c|^2;                             -- cluster.sync --
//   2. |v|^2 = the C partials read through distributed shared memory and
//      added in rank order, so every CTA holds the same bits; v_c normalised;
//   3. the partial u_c = W_c v_c (m floats);               -- cluster.sync --
//   4. u = the C partials added in rank order, then normalised by its own
//      norm, which every CTA computes alike.
//
// Only m-vectors and scalars cross SMs, two cluster exchanges a step; no
// buffer needs a second copy, since the next write to each comes after the
// other exchange's cluster.sync.  Every sum runs in a fixed order without
// atomics, so two launches give equal bits.  CTA 0 writes u, sigma and the
// factor.  The grid may hold more clusters than the card keeps resident;
// they are independent and run in waves.  The plan in
// ops/spectral_norm_cuda.py picks C (1 to 16, the smallest that gives at
// most 144 columns a CTA at the group's widest n) and the shared memory,
// the same arithmetic as sn_layout below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 64;

struct SnConv {
  const float* w;  // (m, n) row-major
  float* u;        // (m,)
  int m, n, n_iter;
  float ln_lambda;
};

struct SnArgs {
  SnConv conv[kMaxGroup];
  float* out;  // (2, G): sigma, then the factor
  int G;
};

__host__ __device__ inline int round_up(int x, int k) { return (x + k - 1) / k * k; }

// Columns a CTA owns: a multiple of 4, so that each slice starts 16 bytes in.
__host__ __device__ inline int sn_seg(int n, int C) { return round_up((n + C - 1) / C, 4); }

// Row stride of the slice in shared memory: the slice's columns padded to
// an odd number of float4s, so that 8 rows read at one column (product 3)
// fall in distinct banks.
__host__ __device__ inline int sn_ld(int seg) {
  const int ld = round_up(seg, 4);
  return (ld / 4) % 2 ? ld : ld + 4;
}

// The shared-memory buffers of one CTA, in floats, each a multiple of 4
// so that every buffer starts on 16 bytes: the slice (m x ld), u, the
// exchanged partial of u, product 3's partials, product 1's partials, v,
// the exchanged scalar and the warps' sums.
struct SnLayout {
  int ld, w, u, part, pc, pa, v, ss, red, total;
};

__host__ __device__ inline SnLayout sn_layout(int m, int n, int C) {
  SnLayout L;
  L.ld = sn_ld(sn_seg(n, C));
  const int mp = round_up(m, 4);
  L.w = 0;
  L.u = L.w + m * L.ld;
  L.part = L.u + mp;
  L.pc = L.part + mp;
  L.pa = L.pc + (mp > kThreads ? mp : kThreads);
  L.v = L.pa + (L.ld > 4 * kThreads ? L.ld : 4 * kThreads);
  L.ss = L.v + L.ld;
  L.red = L.ss + 4;
  L.total = L.red + kWarps;
  return L;
}

// Sum over the CTA; every thread gets the same bits (a butterfly in each
// warp, then the warps' sums in order).
__device__ float block_sum(float x, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s_red[w];
  __syncthreads();  // s_red is free for the next sum
  return total;
}

template <int kC>
__global__ void __launch_bounds__(kThreads) sn_power_cluster(const __grid_constant__ SnArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  const int g = blockIdx.x / kC;
  const SnConv cv = a.conv[g];
  const int m = cv.m, n = cv.n;
  const SnLayout L = sn_layout(m, n, kC);
  const int seg = sn_seg(n, kC), ld = L.ld, q = ld / 4;
  const int c0 = min(n, rank * seg);
  const int ncols = min(n, c0 + seg) - c0;
  const int tid = threadIdx.x;

  float* s_w = smem + L.w;        // m x ld
  float* s_u = smem + L.u;        // m
  float* s_part = smem + L.part;  // m: this CTA's partial of W v
  float* s_pc = smem + L.pc;      // H x m
  float* s_pa = smem + L.pa;      // G1 x ld
  float* s_v = smem + L.v;        // ld
  float* s_ss = smem + L.ss;      // this CTA's partial of |v|^2
  float* s_red = smem + L.red;    // kWarps

  // The slice, its padding columns zero, and u.
  const float* w = cv.w;
  const bool vec = (n % 4) == 0 && (reinterpret_cast<uintptr_t>(w) % 16) == 0;
  for (int idx = tid; idx < m * q; idx += kThreads) {
    const int i = idx / q, j = (idx - i * q) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* src = w + (size_t)i * n + c0 + j;
    if (vec && j + 4 <= ncols) {
      x = __ldg(reinterpret_cast<const float4*>(src));
    } else {
      if (j < ncols) x.x = __ldg(src);
      if (j + 1 < ncols) x.y = __ldg(src + 1);
      if (j + 2 < ncols) x.z = __ldg(src + 2);
      if (j + 3 < ncols) x.w = __ldg(src + 3);
    }
    *reinterpret_cast<float4*>(s_w + i * ld + j) = x;
  }
  for (int i = tid; i < m; i += kThreads) s_u[i] = cv.u[i];
  __syncthreads();

  // Product 1's tiling: G1 row groups by q float4 columns; product 3's:
  // H runs of float4 columns by m rows.
  const int G1 = max(1, min(m, kThreads / q));
  const int H = max(1, min(q, kThreads / m));

  // v = W_c^T u into s_v (padding columns 0); returns the CTA's |v_c|^2,
  // the same in every thread.
  auto product1 = [&]() -> float {
    for (int idx = tid; idx < G1 * q; idx += kThreads) {
      const int r = idx / q, j = (idx - r * q) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = r; i < m; i += G1) {
        const float4 wv = *reinterpret_cast<const float4*>(s_w + i * ld + j);
        const float ui = s_u[i];
        acc.x = fmaf(wv.x, ui, acc.x);
        acc.y = fmaf(wv.y, ui, acc.y);
        acc.z = fmaf(wv.z, ui, acc.z);
        acc.w = fmaf(wv.w, ui, acc.w);
      }
      *reinterpret_cast<float4*>(s_pa + r * ld + j) = acc;
    }
    __syncthreads();
    float ss = 0.f;
    for (int j = tid; j < ld; j += kThreads) {
      float v = 0.f;
      for (int r = 0; r < G1; ++r) v += s_pa[r * ld + j];
      s_v[j] = v;
      ss = fmaf(v, v, ss);
    }
    return block_sum(ss, s_red);
  };

  // The C partials of |v|^2 through distributed shared memory, in rank order.
  auto cluster_ss = [&]() -> float {
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) ss += *cluster.map_shared_rank(s_ss, c);
    return ss;
  };

  for (int step = 0; step < cv.n_iter; ++step) {
    // 1.
    const float ss_c = product1();
    if (tid == 0) *s_ss = ss_c;
    cluster.sync();
    // 2.
    const float dv = sqrtf(cluster_ss()) + 1e-12f;
    for (int j = tid; j < ncols; j += kThreads) s_v[j] = s_v[j] / dv;
    __syncthreads();
    // 3.
    for (int idx = tid; idx < H * m; idx += kThreads) {
      const int h = idx / m, i = idx - h * m;
      float acc = 0.f;
      for (int k = h; k < q; k += H) {
        const float4 wv = *reinterpret_cast<const float4*>(s_w + i * ld + 4 * k);
        const float4 vv = *reinterpret_cast<const float4*>(s_v + 4 * k);
        acc = fmaf(wv.x, vv.x, acc);
        acc = fmaf(wv.y, vv.y, acc);
        acc = fmaf(wv.z, vv.z, acc);
        acc = fmaf(wv.w, vv.w, acc);
      }
      s_pc[h * m + i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < m; i += kThreads) {
      float p = 0.f;
      for (int h = 0; h < H; ++h) p += s_pc[h * m + i];
      s_part[i] = p;
    }
    cluster.sync();
    // 4.
    float ss = 0.f;
    for (int i = tid; i < m; i += kThreads) {
      float x = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) x += cluster.map_shared_rank(s_part, c)[i];
      s_u[i] = x;
      ss = fmaf(x, x, ss);
    }
    const float du = sqrtf(block_sum(ss, s_red)) + 1e-12f;
    for (int i = tid; i < m; i += kThreads) s_u[i] = s_u[i] / du;
    __syncthreads();
  }

  // sigma = |W^T u|.
  const float ss_c = product1();
  if (tid == 0) *s_ss = ss_c;
  cluster.sync();
  const float sigma = sqrtf(cluster_ss());
  if (rank == 0) {
    for (int i = tid; i < m; i += kThreads) cv.u[i] = s_u[i];
    if (tid == 0) {
      const float ratio = sigma / cv.ln_lambda;
      a.out[g] = sigma;
      a.out[a.G + g] = ratio < 1.f ? 1.f : ratio;  // NaN stays NaN, as torch.clamp
    }
  }
  cluster.sync();  // no peer reads this CTA's shared memory after this
}

// The attributes already set on each instance (index log2 C), so that a
// launch recorded into a CUDA graph after the first calls no
// cudaFuncSetAttribute.
int g_smem[5] = {0, 0, 0, 0, 0};
bool g_non_portable[5] = {false, false, false, false, false};

template <int kC>
cudaError_t launch_c(const SnArgs& a, int index, int smem, cudaStream_t stream) {
  auto kernel = sn_power_cluster<kC>;
  cudaError_t err;
  if (smem > g_smem[index]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    g_smem[index] = smem;
  }
  if (kC > 8 && !g_non_portable[index]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    g_non_portable[index] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(kC * a.G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

extern "C" {

int lrs_pnp_sn_max_group() { return kMaxGroup; }

// Dynamic shared memory of one CTA, in bytes, for a conv of (m, n) split
// over C CTAs.
int lrs_pnp_sn_smem_bytes(int m, int n, int C) { return 4 * sn_layout(m, n, C).total; }

// One launch on `stream` for the G convs: w[g] (m[g], n[g]) f32 row-major,
// u[g] (m[g],) advanced in place, out (2, G).  C CTAs a cluster, smem bytes
// of dynamic shared memory each (the largest conv's).  Returns the
// cudaError_t (0 on success), cudaGetLastError checked after the launch.
int lrs_pnp_sn_launch(const float* const* w, float* const* u, const int* m, const int* n,
                      const int* n_iter, const float* ln_lambda, int G, float* out, int C, int smem,
                      void* stream) {
  if (G < 1 || G > kMaxGroup) return (int)cudaErrorInvalidValue;
  SnArgs a = {};
  for (int g = 0; g < G; ++g) a.conv[g] = SnConv{w[g], u[g], m[g], n[g], n_iter[g], ln_lambda[g]};
  a.out = out;
  a.G = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 1: err = launch_c<1>(a, 0, smem, s); break;
    case 2: err = launch_c<2>(a, 1, smem, s); break;
    case 4: err = launch_c<4>(a, 2, smem, s); break;
    case 8: err = launch_c<8>(a, 3, smem, s); break;
    case 16: err = launch_c<16>(a, 4, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error; the caller raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
