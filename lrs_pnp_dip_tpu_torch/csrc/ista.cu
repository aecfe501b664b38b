// Fused masked PnP-ISTA with the closed-form 1-D NLM denoiser, for Hopper.
//
// Replaces the TPU kernel lrs_pnp_dip_tpu/ops/ista_pallas.py:
// pnp_ista_blocks_pallas (pallas_call at :179; body _ista_kernel :81,
// _nlm1d_in_kernel :49, _reflect_selector :35).  One launch runs the whole
// n_iter loop from x0 = 0 for every block:
//
//   pred = x D^T                          (nB, P)
//   g    = x + ((Ym - M * pred) D) * (1/alpha)
//   x    = NLM1d(g)   reflect pad 5 along K; for delta in {1,2,3} the weight
//                     at row i is 7 exp(3 sum_{u=-1..1}(p[i+u]-p[i+delta+u])^2
//                     * nih), nih = -1/(9 h^2), applied forward and
//                     backward; self weight 8; out = num / den.
//
// Inputs: Ym = M*Y and M (nB, P), D (P, K), 1/alpha and nih (nB,), all f32
// and contiguous.  Output: the coefficients x (nB, K) f32.  With bf16 = 1
// the two products take operands rounded to bf16 and accumulate in f32 (a
// product of two bf16 values is exact in f32); the NLM and the carried x
// stay f32.
//
// Bound.  At the main-path shape (nB 144, P 1296, K 512, 100 iterations)
// the work is 4 nB P K n_iter = 3.8e10 flops on 4.5 MB of inputs and
// outputs, so it is bound by operations: in f32 on the CUDA cores
// (67 TFLOP/s on an H100 SXM) no kernel can take less than about 0.57 ms.
//
// Design.  The NLM stencil reaches 4 columns either side along K between
// the two products, so one CTA owns whole rows: a tile of kRows = 8 blocks
// with all K columns.  x, the bf16 operand copy of x, g and the residual
// live in shared memory for the whole loop (90.6 KB at the main shape), so
// nothing but the final x goes back to device memory.  D does not fit in
// shared memory (2.65 MB f32), so every iteration streams it from L2, once
// as D^T (K, P) for pred and once as D (P, K) for the gradient: both
// products then read D with neighbouring threads on neighbouring addresses
// and take x and the residual as shared-memory broadcasts, without
// cross-lane reductions.  A small prep kernel writes D^T (and the
// bf16-rounded D) into scratch the wrapper allocates.
//
// Trade-off.  Each CTA reads D twice per iteration whatever its row count,
// so fewer, wider tiles re-read D from L2 less often in total, but leave
// SMs idle: at 8 rows there are 18 CTAs on 132 SMs for nB = 144.  8 rows
// balance the per-CTA FMA work (8 FMAs per D element read) against the
// per-SM L2 read rate; 4 rows would double the total L2 traffic for the
// same per-CTA read time.  The ragged last tile is masked (rows past nB
// read zeros and are not stored).  wgmma, TMA and splitting K across a
// cluster are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;      // block rows per CTA
constexpr int kThreads = 256;
constexpr int kColsA = 6;     // pred columns per thread per pass (1536 >= P = 1296)
constexpr int kColsB = 2;     // gradient columns per thread per pass (512 = K)

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Index into a row of length K after reflect padding (edge not repeated),
// for offsets within (-K, 2K - 1).
__device__ __forceinline__ int reflect_index(int j, int K) {
  j = j < 0 ? -j : j;
  return j >= K ? 2 * K - 2 - j : j;
}

// Dt[k, p] = op(D[p, k]); in bf16 mode also Dm[p, k] = op(D[p, k]).
__global__ void prep_dictionary(const float* __restrict__ D,
                                float* __restrict__ Dt,
                                float* __restrict__ Dm, int P, int K,
                                int bf16) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, p0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;  // block (32, 8)
  for (int i = ty; i < 32; i += 8) {
    const int p = p0 + i, k = k0 + tx;
    if (p < P && k < K) {
      float v = D[(size_t)p * K + k];
      if (bf16) {
        v = round_bf16(v);
        Dm[(size_t)p * K + k] = v;
      }
      tile[i][tx] = v;
    }
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, p = p0 + tx;
    if (p < P && k < K) Dt[(size_t)k * P + p] = tile[tx][i];
  }
}

__global__ void __launch_bounds__(kThreads)
pnp_ista_kernel(const float* __restrict__ ym, const float* __restrict__ m,
                const float* __restrict__ Dm, const float* __restrict__ Dt,
                const float* __restrict__ inv_alpha,
                const float* __restrict__ nih, float* __restrict__ out,
                int nB, int P, int K, int n_iter, int bf16) {
  extern __shared__ float4 smem4[];
  float* s_x = reinterpret_cast<float*>(smem4);  // [kRows][K] carried x
  float* s_xm = s_x + kRows * K;                 // [K][kRows] product operand of x
  float* s_g = s_xm + kRows * K;                 // [kRows][K] gradient step
  float* s_r = s_g + kRows * K;                  // [P][kRows] masked residual

  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, nB - row0);
  const int tid = threadIdx.x;

  float ia[kRows], nh[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    ia[r] = r < nrows ? inv_alpha[row0 + r] : 0.f;
    nh[r] = r < nrows ? nih[row0 + r] : -1.f;
  }
  for (int i = tid; i < kRows * K; i += kThreads) {
    s_x[i] = 0.f;
    s_xm[i] = 0.f;
  }
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    // 1. residual r = Ym - M * (x D^T); thread owns columns p.
    for (int p0 = 0; p0 < P; p0 += kThreads * kColsA) {
      float acc[kColsA][kRows];
      int pc[kColsA];
#pragma unroll
      for (int c = 0; c < kColsA; ++c) {
        pc[c] = p0 + tid + c * kThreads;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;
      }
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        const float4 xa = *reinterpret_cast<const float4*>(s_xm + k * kRows);
        const float4 xb = *reinterpret_cast<const float4*>(s_xm + k * kRows + 4);
        const float xr[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        const float* drow = Dt + (size_t)k * P;
#pragma unroll
        for (int c = 0; c < kColsA; ++c) {
          const float d = pc[c] < P ? __ldg(drow + pc[c]) : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[c][r] = fmaf(xr[r], d, acc[c][r]);
        }
      }
#pragma unroll
      for (int c = 0; c < kColsA; ++c) {
        if (pc[c] >= P) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float v = 0.f;
          if (r < nrows) {
            const size_t idx = (size_t)(row0 + r) * P + pc[c];
            v = ym[idx] - m[idx] * acc[c][r];
            if (bf16) v = round_bf16(v);
          }
          s_r[pc[c] * kRows + r] = v;
        }
      }
    }
    __syncthreads();

    // 2. g = x + (r D) * (1/alpha); thread owns columns k.
    for (int k0 = 0; k0 < K; k0 += kThreads * kColsB) {
      float acc[kColsB][kRows];
      int kc[kColsB];
#pragma unroll
      for (int c = 0; c < kColsB; ++c) {
        kc[c] = k0 + tid + c * kThreads;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;
      }
#pragma unroll 2
      for (int p = 0; p < P; ++p) {
        const float4 ra = *reinterpret_cast<const float4*>(s_r + p * kRows);
        const float4 rb = *reinterpret_cast<const float4*>(s_r + p * kRows + 4);
        const float rr[kRows] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
        const float* drow = Dm + (size_t)p * K;
#pragma unroll
        for (int c = 0; c < kColsB; ++c) {
          const float d = kc[c] < K ? __ldg(drow + kc[c]) : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[c][r] = fmaf(rr[r], d, acc[c][r]);
        }
      }
#pragma unroll
      for (int c = 0; c < kColsB; ++c) {
        if (kc[c] >= K) continue;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          s_g[r * K + kc[c]] = s_x[r * K + kc[c]] + acc[c][r] * ia[r];
      }
    }
    __syncthreads();

    // 3. x = NLM1d(g), one output element per thread step.
    for (int e = tid; e < kRows * K; e += kThreads) {
      const int r = e / K, k = e - r * K;
      const float* g = s_g + r * K;
      float v[9];  // v[4 + j] = padded g at offset j from k
#pragma unroll
      for (int j = -4; j <= 4; ++j) v[4 + j] = g[reflect_index(k + j, K)];
      float num = 8.f * v[4];
      float den = 8.f;
#pragma unroll
      for (int delta = 1; delta <= 3; ++delta) {
        // forward: the window about row k, partner k + delta
        float a = v[3] - v[3 + delta], b = v[4] - v[4 + delta], c = v[5] - v[5 + delta];
        const float wf = 7.f * expf(3.f * (a * a + b * b + c * c) * nh[r]);
        num += wf * v[4 + delta];
        den += wf;
        // backward: the window about row k - delta, partner k
        a = v[3 - delta] - v[3];
        b = v[4 - delta] - v[4];
        c = v[5 - delta] - v[5];
        const float wb = 7.f * expf(3.f * (a * a + b * b + c * c) * nh[r]);
        num += wb * v[4 - delta];
        den += wb;
      }
      const float x = num / den;
      s_x[e] = x;
      s_xm[k * kRows + r] = bf16 ? round_bf16(x) : x;
    }
    __syncthreads();
  }

  for (int e = tid; e < nrows * K; e += kThreads) out[(size_t)row0 * K + e] = s_x[e];
}

}  // namespace

extern "C" {

// Dynamic shared memory the main kernel needs for (P, K), in bytes.
int lrs_pnp_ista_smem_bytes(int P, int K) {
  return (int)((3 * (size_t)kRows * K + (size_t)kRows * P) * sizeof(float));
}

// Launches the prep and the fused loop on `stream`; returns the
// cudaError_t of the launches (0 on success).  dt is (K, P) scratch and dm
// (P, K) scratch, written and read in bf16 mode only (it may be null in f32
// mode).
int lrs_pnp_ista_launch(const float* ym, const float* m, const float* d,
                        const float* inv_alpha, const float* nih, float* dt,
                        float* dm, float* out, int nB, int P, int K,
                        int n_iter, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tblock(32, 8), tgrid((K + 31) / 32, (P + 31) / 32);
  prep_dictionary<<<tgrid, tblock, 0, s>>>(d, dt, dm, P, K, bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = lrs_pnp_ista_smem_bytes(P, K);
  err = cudaFuncSetAttribute(pnp_ista_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (nB + kRows - 1) / kRows;
  pnp_ista_kernel<<<grid, kThreads, smem, s>>>(ym, m, bf16 ? dm : d, dt,
                                               inv_alpha, nih, out, nB, P, K,
                                               n_iter, bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
