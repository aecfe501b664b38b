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
// Inputs: Y and M (nB, P), D (P, K), alpha (nB,), all f32 and contiguous,
// and the scalar h_coef with h = h_coef / (2 alpha).  Ym = M*Y, 1/alpha and
// nih are derived in the kernel, so a call launches nothing else.  Output:
// the coefficients x (nB, K) f32.  In bf16 mode the
// two products take operands rounded to bf16 and accumulate in f32 (a
// product of two bf16 values is exact in f32); the NLM and the carried x
// stay f32.
//
// Bound.  At the main-path shape (nB 144, P 1296, K 512, 100 iterations)
// the work is 4 nB P K n_iter = 3.8e10 flops on 4.5 MB of inputs and
// outputs, so it is bound by operations: 0.57 ms in f32 on the CUDA cores
// (67 TFLOP/s on an H100 SXM), 0.039 ms with bf16 operands on the tensor
// cores (989 TFLOP/s).
//
// Design.  D (2.65 MB in f32) does not fit one CTA's 227 KB of shared
// memory, but it fits a thread block cluster's.  A cluster of C CTAs owns R
// block rows for the whole loop, and CTA c keeps the slice D[p_c, :]
// (P/C rows, all K columns) in its shared memory from the first iteration to
// the last: D is read from device memory once per cluster and never again.
// That one slice serves both products:
//
//   1. pred[:, p_c] = x D[p_c, :]^T needs all K of x for the R rows (every
//      CTA holds a copy of x) and gives the CTA's own residual slice
//      r[:, p_c] = Ym - M * pred, which never leaves the CTA;
//   2. the partial gradient r[:, p_c] D[p_c, :] (R, K) stays in the CTA's
//      shared memory;                                   -- cluster.sync --
//   3. CTA c owns K/C columns.  It sums the C partials of those columns and
//      of a halo of 4 either side (the NLM's reach) through distributed
//      shared memory, in a ring order that is fixed for the CTA (from its
//      successor on, so that the peers are not all read at once), so two
//      launches give the same bits; it
//      adds the carried x, runs the NLM on its columns and writes the new x
//      into every peer's operand copy.                  -- cluster.sync --
//
// Clusters are independent of each other (rows never interact), so the grid
// may hold more clusters than the card keeps resident; they run in waves.
// With one CTA per SM an H100 SXM keeps 15 clusters of 8 or 7 clusters of 16
// resident (scripts/probe_clusters.cu); the wrapper asks the card and the
// plan in ops/ista_cuda.py sizes R for the answer.
//
// f32 mode is exact f32 on the CUDA cores.  The f32 slice is resident at
// C = 16 (81 x 512 x 4 B = 166 KB at the main shape), a cluster size that
// needs cudaFuncAttributeNonPortableClusterSizeAllowed.  Product 1 gives
// each warp an eighth of K and each lane up to 3 columns p for all 11 rows
// (33 accumulators; x is a shared-memory broadcast, D a conflict-free
// 16-byte load thanks to a row stride of K + 4 floats); the 8 partial tiles
// are summed in warp order.  Product 2 gives each thread 4 columns k for all
// 11 rows (44 accumulators) over half of the slice's rows, and the two
// halves are added in a fixed order.
//
// bf16 mode stores the slice in bf16 (half the bytes: resident at C = 8)
// and runs both products on the tensor cores with mma.sync.m16n8k16, f32
// accumulators: the row tile is 16, of which R <= 16 rows are real.  The
// slice [p][k] is the "col" B operand of product 1 as it lies (ldmatrix) and
// of product 2 through ldmatrix.trans, so one copy serves both.  x and the
// residual are rounded to bf16 once, when they are written as operands.  The
// f32 -> bf16 conversion of D happens while the slice is loaded, inside the
// launch; nothing is cached between launches.
//
// What bounds it now (scripts/profile_b1_phases.py, NVIDIA H100 80GB HBM3,
// 700.00 W, main shape): in f32 the two products take about 60% of an
// iteration and run FMAs at about 45% of the SM's rate, the broadcast loads
// of x and r costing a quarter of that time; step 3 and the two cluster
// syncs take the rest.  Step 3 moves about 50 KB per CTA and iteration
// through distributed shared memory at some 10 bytes per clock, and nothing
// overlaps it: the next product needs every CTA's new x.  In bf16 the
// products take half the cycles of the f32 ones, and step 3 and the syncs
// are half of the time.
//
// The streamed path (pnp_ista_stream, f32 and bf16).  The resident kernels
// take a shape only while a CTA's slice of D fits its register tiles (at most
// 96 rows in f32, K <= 640 in bf16) and shared memory beside the operand copy
// of x and the partial gradient.  Up to K 1024 (f32) or 1280 (bf16) every
// other shape of the TPU kernel's range (its wrapper's VMEM arithmetic at its
// smallest tile, 2 P K 4 + 3 8 (2P + 2K + 10) 4 <= 12 MiB: block 52 at K 512,
// K 1152 at P 1296) takes the streamed kernel, which keeps the resident
// kernels' mould -- a cluster of C CTAs owns R <= 16 block rows, CTA c the
// slice D[p_c, :], step 3 as above -- but holds only the first Pr rows of the
// slice in shared memory:
//
//   0. a producer warp streams the rest of the slice, once per iteration, as
//      stages of whole rows (16, or 8 in f32 past K 512) into a ring of
//      three slots, one bulk copy (the TMA's one-dimensional form) per row,
//      completing on the slot's "full" mbarrier; it refills a slot when the
//      consumers have arrived on its "empty" mbarrier.  bf16 stages come
//      from a copy of D rounded once per launch (a second kernel before the
//      loop, into scratch the wrapper allocates), so they move half the bytes;
//   1. the consumers (16 warps in f32, 8 in bf16) walk the stages in order,
//      resident first.  Step j runs product 2 of stage j - 2 (r_s D_s added
//      into the CTA's partial gradient, which stays in registers for the
//      whole pass) and releases its slot, then the residual of stage j - 1
//      (the warps' partial sums of product 1 added in warp order), then
//      product 1 of stage j (x D_s^T, the warps splitting K), under one
//      barrier of the consumers per step.  f32 runs on the CUDA cores with
//      register tiles of 12 or 16 block rows (12 when R <= 12) by 4 stage
//      rows and the two half-warps' sums added by a shuffle; bf16 runs both
//      products on mma.sync, B through ldmatrix(.trans) from one copy of the
//      rows.  Each streamed row is read from L2 once per iteration, and no
//      row outside the CTA's slice is read;
//   2. the partial gradient goes to shared memory in the ring's place, and
//      step 3 (reduce_nlm_push, init_rows and write_out are the resident
//      kernels', with all the CTA's threads) sums it through the cluster in
//      the fixed ring order.  Then its place is zeroed again: a short last
//      stage copies only its valid rows, and the rest of its slot must
//      hold zeros or rows of D, not gradient bits read as bf16 (NaN).
//
// Nothing goes through device memory per iteration.  Every sum runs in a
// fixed order without atomics, so two launches give equal bits.  bf16 rounds
// x and r once, where they are written as operands, and D once per launch.
// Bound: the same 4 nB P K n_iter operations (at block 40, K 512, nB 144:
// 4.7e10 flops, 0.70 ms in f32 on the CUDA cores); besides, each cluster
// streams C (Pc - Pr) K values of D per iteration (IstaPlan.
// l2_bytes_per_iteration).  What bounds it now (scripts/profile_b1_phases.py,
// NVIDIA H100 80GB HBM3, 700.00 W): in f32 the products run at about a third
// of the FMA rate with sixteen warps, and with the products' loops taken out
// the pipeline alone (copies, barriers, sums) still took half of the time;
// in bf16 step 3 and the cluster syncs take half of an iteration.  The
// plan takes one wave of clusters of 8 over two of 16 (measured faster at
// every streamed shape) and the most resident rows that fit beside the ring.
//
// The long-K tail (pnp_ista_column_f32 / _bf16): past the streamed kernel's
// columns (K > 1024 in f32, > 1280 in bf16) the per-CTA copy of x and the
// partial gradient, both of all K, no longer fit.  The column kernels
// exchange the roles of P and K: a cluster of C CTAs owns R block rows, and
// CTA c owns the columns k_c = [c seg, (c + 1) seg) of x and of D for all P
// rows, so nothing it keeps grows with K beyond K / C.  The first Pr rows of
// D[:, k_c] stay in shared memory; the rest are read from L2 straight into
// the registers of each product (f32: D itself, or a copy with rows padded
// to 16 bytes; bf16: D rounded once per launch and its transpose, so that
// both products' B fragments are 32-bit loads).  Each iteration:
//
//   1. the partial pred_c = x[:, k_c] D[:, k_c]^T over all P into an R x P
//      buffer (f32: a group of 8 lanes per row of D, float4 columns split
//      over the lanes and their sums added by a butterfly, all rows of x a
//      thread; bf16: mma.sync with D's rows as the "col" B operand, the
//      chain cut every 8 k steps into a rounded f32 sum);  -- cluster.sync --
//   2. CTA c sums the C partials of its Pc rows of the residual through
//      distributed shared memory in the fixed ring order from its
//      successor, forms r = Ym - M pred (bf16: rounded once) and writes it
//      into every CTA's buffer in place of the partial;      -- cluster.sync --
//   3. g[:, k_c] = x + (r D[:, k_c]) / alpha over all P: no sum crosses CTAs
//      (f32: a float4 column by all rows of x a thread over a run of rows of
//      D, the runs' sums added in order; bf16: mma.sync with B through
//      ldmatrix.trans or from the transpose, split over two halves of the
//      warps by 16-row steps where the CTA has at most 16 column tiles, each
//      half's chain cut every 8 steps into a rounded f32 sum);
//                                                         -- cluster.sync --
//   4. the halo of 4 columns either side from the neighbours' g, the NLM on
//      the CTA's columns, the new x in place.
//
// Only R x P values cross distributed shared memory each way per
// iteration, and nothing goes through device memory.  Every sum runs in a
// fixed order without atomics, so two launches give equal bits.  Bound:
// the same 4 nB P K n_iter operations; besides, each CTA reads its rows of
// D[:, k_c] past Pr from L2 twice per iteration (IstaPlan.
// l2_bytes_per_iteration).  What bounds it now (scripts/profile_b1_phases.py
// --shapes long, NVIDIA H100 80GB HBM3, 700.00 W): in f32 the two products
// take 70 to 87% of an iteration, product 1 the larger share (its lanes'
// butterfly and x's broadcasts per row of D), with D crossing L2 at some 20
// GB/s per SM; in bf16 the products take half and the NLM and the three
// cluster syncs the rest.  The plan takes one wave of clusters of 8 where it
// can (R 10 at nB 144) and the most resident rows that fit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsF32 = 11;   // rows of the f32 register tiles (R <= 11)
constexpr int kRowsBf16 = 16;  // rows of the mma tile (R <= 16)
constexpr int kColsP = 3;      // f32 product 1: columns p per lane (slice rows <= 96)
constexpr int kTilesP = 3;     // bf16 product 1: 8-wide p tiles per warp (slice rows <= 192)
constexpr int kPairsK = 5;     // bf16 product 2: 16-wide k tiles per warp (K <= 640)
constexpr int kHalo = 4;       // the NLM's reach along K
constexpr int kLdR = 12;       // f32 residual: floats per p (11 rows and a pad)

// With -DISTA_PROFILE thread 0 of CTA 0 adds up the clock cycles of the
// phases of an iteration (scripts/profile_b1_phases.py reads them); without
// it the clock compiles to nothing.
#ifdef ISTA_PROFILE
__device__ long long g_phase_cycles[8];
struct PhaseClock {
  long long t;
  __device__ __forceinline__ void begin() { t = clock64(); }
  __device__ __forceinline__ void end(int phase) {
    if (threadIdx.x == 0 && blockIdx.x == 0) {
      const long long now = clock64();
      g_phase_cycles[phase] += now - t;
      t = now;
    }
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void end(int) {}
};
#endif

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets of the buffers in dynamic shared memory.  ops/ista_cuda.py
// computes the same total in its plan.
struct Layout {
  int kp;    // K padded: to 4 floats (f32) or 32 bf16 values
  int ld;    // row stride of the slice and of the operand x, in elements
  int pcp;   // slice rows padded (bf16: to 16)
  int ldg;   // row stride of the partial gradient: kp + 8 floats, so that the
             // mma accumulators' rows fall into different banks
  int d, x, g, r, xown, vec, total;
};

__host__ __device__ inline Layout make_layout(int bf16, int R, int Pc, int K, int seg) {
  Layout L;
  int bytes_d, bytes_x, bytes_g, bytes_r;
  if (bf16) {
    L.kp = round_up(K, 32);
    L.ld = L.kp + 8;
    L.ldg = L.kp + 8;
    L.pcp = round_up(Pc, 16);
    bytes_d = L.pcp * L.ld * 2;
    bytes_x = kRowsBf16 * L.ld * 2;
    bytes_g = R * L.ldg * 4;
    bytes_r = imax(kRowsBf16 * (L.pcp + 8) * 2, R * (seg + 2 * kHalo) * 4);
  } else {
    L.kp = round_up(K, 4);
    L.ld = L.kp + 4;
    L.ldg = L.kp + 8;
    L.pcp = Pc;
    bytes_d = Pc * L.ld * 4;
    bytes_x = kRowsF32 * L.kp * 4;
    bytes_g = imax(R * L.ldg, kWarps * R * Pc) * 4;
    bytes_r = imax(Pc * kLdR, R * (seg + 2 * kHalo)) * 4;
  }
  L.d = 0;
  L.x = L.d + round_up(bytes_d, 16);
  L.g = L.x + round_up(bytes_x, 16);
  L.r = L.g + round_up(bytes_g, 16);
  L.xown = L.r + round_up(bytes_r, 16);
  L.vec = L.xown + round_up(2 * R * seg * 4, 16);
  L.total = L.vec + 2 * kRowsBf16 * 4;
  return L;
}

struct Args {
  const float* y;      // (nB, P) target blocks
  const float* m;      // (nB, P) mask
  const float* d;      // (P, K) dictionary
  const float* alpha;  // (nB,) step sizes
  float h_coef;        // the NLM's h is h_coef / (2 alpha)
  float* out;
  int nB, P, K, n_iter;
  int R;    // rows per cluster
  int Pc;   // rows of D per CTA (the last slices may be shorter or empty)
  int seg;  // columns of x per CTA in step 3, a multiple of 4
};

// Index into a row of length K after reflect padding (edge not repeated),
// for offsets within (-K, 2K - 1).
__device__ __forceinline__ int reflect_index(int j, int K) {
  j = j < 0 ? -j : j;
  return j >= K ? 2 * K - 2 - j : j;
}

// Four consecutive values of x as product operands: f32 as they are, or
// rounded to bf16.
__device__ __forceinline__ void store_operand4(float* x, float4 v) {
  *reinterpret_cast<float4*>(x) = v;
}
__device__ __forceinline__ void store_operand4(__nv_bfloat16* x, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(x) = packed;
}

// Step 3 of an iteration, between the two cluster syncs: the partial
// gradients of every CTA are complete in s_g.  Sums them for this CTA's
// columns and halo in rank order, adds the carried x, runs the NLM and
// writes the new x: in f32 into this CTA's s_xown[nxt], and as a product
// operand into every CTA's s_x.
template <typename OperandT, int kNT = kThreads>
__device__ __forceinline__ void reduce_nlm_push(
    cg::cluster_group& cluster, const Args& a, const Layout& L, float* s_g,
    float* s_gseg, float* s_xown, OperandT* s_x, int ld_x, const float* s_ia,
    const float* s_nih, int nrows, int cur, PhaseClock& clock) {
  const int C = cluster.num_blocks();
  const int tid = threadIdx.x;
  const int K = a.K, seg = a.seg, R = a.R;
  const int rank = cluster.block_rank();
  const int k0 = min(K, rank * seg);
  const int k1 = min(K, k0 + seg);
  const int lo = max(0, k0 - kHalo), hi = min(K, k1 + kHalo);
  const int ldgs = seg + 2 * kHalo;
  // k0, lo, seg and every row stride are multiples of 4, so the columns
  // [lo, hi) go as 16-byte accesses; a last group may reach past K into
  // padding that holds zeros.
  const int nquad = k1 > k0 ? (hi - lo + 3) / 4 : 0;

  for (int e = tid; e < nrows * nquad; e += kNT) {
    const int r = e / nquad, col = lo + 4 * (e - r * nquad);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    // Peers in ring order from this CTA's successor, so that the CTAs of a
    // cluster do not all read the same peer at once; the order is fixed for
    // a rank, so the sum is reproducible.
#pragma unroll 8
    for (int i = 0; i < C; ++i) {
      const int c = (rank + 1 + i) & (C - 1);
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(s_g, c) + r * L.ldg + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int owner = col / seg;
    const float4 xo = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(s_xown, owner) + (cur * R + r) * seg + (col - owner * seg));
    const float ia = s_ia[r];
    *reinterpret_cast<float4*>(s_gseg + r * ldgs + (col - k0 + kHalo)) =
        make_float4(xo.x + s.x * ia, xo.y + s.y * ia, xo.z + s.z * ia, xo.w + s.w * ia);
  }
  __syncthreads();
  clock.end(4);

  const int nseg = k1 - k0;
  float* x_new = s_xown + (cur ^ 1) * R * seg;
  for (int e = tid; e < nrows * nseg; e += kNT) {
    const int r = e / nseg, k = k0 + (e - r * nseg);
    const float* g = s_gseg + r * ldgs + (kHalo - k0);  // g[col] for col in [lo, hi)
    const float nh = s_nih[r];
    float v[9];  // v[4 + j] = padded g at offset j from k
#pragma unroll
    for (int j = -4; j <= 4; ++j) v[4 + j] = g[reflect_index(k + j, K)];
    float num = 8.f * v[4];
    float den = 8.f;
#pragma unroll
    for (int delta = 1; delta <= 3; ++delta) {
      // forward: the window about row k, partner k + delta
      float p = v[3] - v[3 + delta], q = v[4] - v[4 + delta], s = v[5] - v[5 + delta];
      const float wf = 7.f * expf(3.f * (p * p + q * q + s * s) * nh);
      num += wf * v[4 + delta];
      den += wf;
      // backward: the window about row k - delta, partner k
      p = v[3 - delta] - v[3];
      q = v[4 - delta] - v[4];
      s = v[5 - delta] - v[5];
      const float wb = 7.f * expf(3.f * (p * p + q * q + s * s) * nh);
      num += wb * v[4 - delta];
      den += wb;
    }
    x_new[r * seg + (k - k0)] = num / den;
  }
  __syncthreads();
  clock.end(5);

  // The new x of this CTA's columns, 4 at a time, into every CTA's operand
  // copy (columns past K hold zeros on both sides).
  const int nsq = (nseg + 3) / 4;
  for (int e = tid; e < C * nrows * nsq; e += kNT) {
    const int i = e / (nrows * nsq), rem = e - i * (nrows * nsq);
    const int c = (rank + 1 + i) & (C - 1);
    const int r = rem / nsq, j = 4 * (rem - r * nsq);
    const float4 x = *reinterpret_cast<const float4*>(x_new + r * seg + j);
    store_operand4(cluster.map_shared_rank(s_x, c) + r * ld_x + k0 + j, x);
  }
  clock.end(6);
}

// Zeroes the carried x and derives the per-row scalars, common to both kernels.
template <int kNT = kThreads>
__device__ __forceinline__ void init_rows(const Args& a, float* s_xown, float* s_ia,
                                          float* s_nih, int row0, int nrows) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * a.R * a.seg; i += kNT) s_xown[i] = 0.f;
  if (tid < kRowsBf16) {
    // 1/alpha and -1/(9 h^2), with the clamps of the plain version
    float ia = 0.f, nih = -1.f;
    if (tid < nrows) {
      const float alpha = fmaxf(a.alpha[row0 + tid], 1e-12f);
      const float h = a.h_coef / (2.0f * alpha);
      ia = 1.0f / alpha;
      nih = -1.0f / fmaxf(h * h * 9.0f, 1e-30f);
    }
    s_ia[tid] = ia;
    s_nih[tid] = nih;
  }
}

template <int kNT = kThreads>
__device__ __forceinline__ void write_out(cg::cluster_group& cluster, const Args& a,
                                          const float* s_xown, int row0, int nrows, int cur) {
  const int k0 = min(a.K, (int)cluster.block_rank() * a.seg);
  const int nseg = min(a.K, k0 + a.seg) - k0;
  for (int e = threadIdx.x; e < nrows * nseg; e += kNT) {
    const int r = e / nseg, k = e - r * nseg;
    a.out[(size_t)(row0 + r) * a.K + k0 + k] = s_xown[(cur * a.R + r) * a.seg + k];
  }
}

// ---------------------------------------------------------------- f32 ----

__global__ void __launch_bounds__(kThreads) pnp_ista_cluster_f32(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout L = make_layout(0, a.R, a.Pc, a.K, a.seg);
  float* s_d = reinterpret_cast<float*>(smem + L.d);     // [Pc][ld] slice of D
  float* s_x = reinterpret_cast<float*>(smem + L.x);     // [11][kp] operand x
  float* s_g = reinterpret_cast<float*>(smem + L.g);     // [R][ldg] partial gradient
  float* s_part = s_g;                                   // [8][R][Pc] product 1 per warp
  float* s_r = reinterpret_cast<float*>(smem + L.r);     // [Pc][12] residual
  float* s_gseg = s_r;                                   // [R][seg + 8] in step 3
  float* s_xown = reinterpret_cast<float*>(smem + L.xown);  // [2][R][seg] carried x
  float* s_ia = reinterpret_cast<float*>(smem + L.vec);
  float* s_nih = s_ia + kRowsBf16;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = cluster.block_rank();
  const int cluster_id = blockIdx.x / cluster.num_blocks();
  const int row0 = cluster_id * a.R;
  const int nrows = min(a.R, a.nB - row0);
  const int p0 = min(a.P, rank * a.Pc);
  const int pc = min(a.P, p0 + a.Pc) - p0;  // this CTA's rows of D
  const int K = a.K, kp = L.kp, ld = L.ld;

  // The slice of D, zero in the padded columns; x = 0.
  if (K % 4 == 0) {  // rows of D are 16-byte aligned
    const float4* d4 = reinterpret_cast<const float4*>(a.d + (size_t)p0 * K);
    const int nq4 = K / 4;
#pragma unroll 4
    for (int i = tid; i < pc * nq4; i += kThreads) {
      const int p = i / nq4, q = i - p * nq4;
      reinterpret_cast<float4*>(s_d + p * ld)[q] = __ldg(d4 + i);
    }
  } else {
    for (int i = tid; i < pc * kp; i += kThreads) {
      const int p = i / kp, k = i - p * kp;
      s_d[p * ld + k] = k < K ? a.d[(size_t)(p0 + p) * K + k] : 0.f;
    }
  }
  for (int i = tid; i < kRowsF32 * kp; i += kThreads) s_x[i] = 0.f;
  init_rows(a, s_xown, s_ia, s_nih, row0, nrows);

  // Ym and M of the residual elements this thread finishes in step 1.
  constexpr int kRes = (kRowsF32 * 32 * kColsP + kThreads - 1) / kThreads;
  float ymr[kRes], mr[kRes];
#pragma unroll
  for (int i = 0; i < kRes; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / max(pc, 1), p = e - r * max(pc, 1);
    const bool ok = pc > 0 && r < nrows;
    mr[i] = ok ? a.m[(size_t)(row0 + r) * a.P + p0 + p] : 0.f;
    ymr[i] = ok ? mr[i] * a.y[(size_t)(row0 + r) * a.P + p0 + p] : 0.f;
  }
  cluster.sync();

  const int nq = kp / 4;                      // float4 columns of K
  const int qpw = (nq + kWarps - 1) / kWarps; // per warp in product 1
  const int qa = min(nq, warp * qpw), qb = min(nq, qa + qpw);
  const int half = tid >> 7, tq = tid & 127;  // product 2
  const int ph = (pc + 1) / 2;
  const int pa = half ? ph : 0, pb = half ? pc : ph;

  int cur = 0;
  PhaseClock clock;
  clock.begin();
  for (int it = 0; it < a.n_iter; ++it) {
    // 1. pred = x D_c^T over this warp's share of K, all rows, lane's columns p.
    {
      float acc[kColsP][kRowsF32];
      const float4* drow[kColsP];
#pragma unroll
      for (int j = 0; j < kColsP; ++j) {
        const int p = lane + 32 * j;
        drow[j] = reinterpret_cast<const float4*>(s_d + (p < pc ? p : 0) * ld);
#pragma unroll
        for (int r = 0; r < kRowsF32; ++r) acc[j][r] = 0.f;
      }
      const float4* x4 = reinterpret_cast<const float4*>(s_x);
#pragma unroll 1
      for (int q = qa; q < qb; ++q) {
        float dv[kColsP][4], xv[kRowsF32][4];
#pragma unroll
        for (int j = 0; j < kColsP; ++j)
          *reinterpret_cast<float4*>(dv[j]) = drow[j][q];
#pragma unroll
        for (int r = 0; r < kRowsF32; ++r)
          *reinterpret_cast<float4*>(xv[r]) = x4[r * nq + q];
        // neighbouring FMAs go to different accumulators
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int r = 0; r < kRowsF32; ++r)
#pragma unroll
            for (int j = 0; j < kColsP; ++j) acc[j][r] = fmaf(xv[r][i], dv[j][i], acc[j][r]);
      }
#pragma unroll
      for (int j = 0; j < kColsP; ++j) {
        const int p = lane + 32 * j;
        if (p < pc) {
#pragma unroll
          for (int r = 0; r < kRowsF32; ++r)
            if (r < a.R) s_part[(warp * a.R + r) * pc + p] = acc[j][r];
        }
      }
    }
    __syncthreads();
    clock.end(0);
    // residual r = Ym - M * pred, the warps' partial sums taken in warp order
#pragma unroll
    for (int i = 0; i < kRes; ++i) {
      const int e = tid + i * kThreads;
      if (e < a.R * pc) {
        const int r = e / pc, p = e - r * pc;
        float pred = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) pred += s_part[w * a.R * pc + e];
        s_r[p * kLdR + r] = ymr[i] - mr[i] * pred;
      }
    }
    __syncthreads();
    clock.end(1);

    // 2. partial gradient r_c D_c: 4 columns k per thread, all rows, half of
    // the slice's rows; the two halves are added in a fixed order.
    for (int qbase = 0; qbase < nq; qbase += 128) {
      const int q = qbase + tq;
      const bool active = q < nq;
      float4 acc[kRowsF32];
#pragma unroll
      for (int r = 0; r < kRowsF32; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (active) {
#pragma unroll 8
        for (int p = pa; p < pb; ++p) {
          const float4 dv = reinterpret_cast<const float4*>(s_d + p * ld)[q];
          const float4* rp = reinterpret_cast<const float4*>(s_r + p * kLdR);
          const float4 ra = rp[0], rb = rp[1], rc = rp[2];
          const float rr[kLdR] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y,
                                  rb.z, rb.w, rc.x, rc.y, rc.z, rc.w};
#pragma unroll
          for (int r = 0; r < kRowsF32; ++r) {
            acc[r].x = fmaf(rr[r], dv.x, acc[r].x);
            acc[r].y = fmaf(rr[r], dv.y, acc[r].y);
            acc[r].z = fmaf(rr[r], dv.z, acc[r].z);
            acc[r].w = fmaf(rr[r], dv.w, acc[r].w);
          }
        }
      }
      // s_part was read out before the last barrier; s_g takes its place
      if (active && half == 1) {
#pragma unroll
        for (int r = 0; r < kRowsF32; ++r)
          if (r < a.R) reinterpret_cast<float4*>(s_g + r * L.ldg)[q] = acc[r];
      }
      __syncthreads();
      if (active && half == 0) {
#pragma unroll
        for (int r = 0; r < kRowsF32; ++r) {
          if (r < a.R) {
            float4* gp = reinterpret_cast<float4*>(s_g + r * L.ldg) + q;
            const float4 o = *gp;
            *gp = make_float4(acc[r].x + o.x, acc[r].y + o.y, acc[r].z + o.z, acc[r].w + o.w);
          }
        }
      }
    }
    clock.end(2);
    cluster.sync();
    clock.end(3);

    // 3. reduce over the cluster, NLM, new x to every CTA
    reduce_nlm_push(cluster, a, L, s_g, s_gseg, s_xown, s_x, kp, s_ia, s_nih, nrows, cur, clock);
    cur ^= 1;
    cluster.sync();
    clock.end(7);
  }
  write_out(cluster, a, s_xown, row0, nrows, cur);
}

// --------------------------------------------------------------- bf16 ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads) pnp_ista_cluster_bf16(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout L = make_layout(1, a.R, a.Pc, a.K, a.seg);
  __nv_bfloat16* s_d = reinterpret_cast<__nv_bfloat16*>(smem + L.d);  // [pcp][ld] slice of D
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + L.x);  // [16][ld] operand x
  float* s_g = reinterpret_cast<float*>(smem + L.g);                  // [R][ldg] partial gradient
  __nv_bfloat16* s_r = reinterpret_cast<__nv_bfloat16*>(smem + L.r);  // [16][pcp + 8] residual
  float* s_gseg = reinterpret_cast<float*>(smem + L.r);               // [R][seg + 8] in step 3
  float* s_xown = reinterpret_cast<float*>(smem + L.xown);            // [2][R][seg] carried x
  float* s_ia = reinterpret_cast<float*>(smem + L.vec);
  float* s_nih = s_ia + kRowsBf16;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // the mma fragments' row and column pair
  const int rank = cluster.block_rank();
  const int cluster_id = blockIdx.x / cluster.num_blocks();
  const int row0 = cluster_id * a.R;
  const int nrows = min(a.R, a.nB - row0);
  const int p0 = min(a.P, rank * a.Pc);
  const int pc = min(a.P, p0 + a.Pc) - p0;
  const int K = a.K, kp = L.kp, ld = L.ld, pcp = L.pcp, ldr = pcp + 8;

  // The slice of D rounded to bf16, zero in the padded rows and columns.
  if (K % 4 == 0) {  // rows of D are 16-byte aligned
    const float4* d4 = reinterpret_cast<const float4*>(a.d + (size_t)p0 * K);
    const int nq4 = kp / 4, nqk = K / 4;
#pragma unroll 4
    for (int i = tid; i < pcp * nq4; i += kThreads) {
      const int p = i / nq4, q = i - p * nq4;
      const float4 v = (p < pc && q < nqk) ? __ldg(d4 + p * nqk + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      store_operand4(s_d + p * ld + 4 * q, v);
    }
  } else {
    for (int i = tid; i < pcp * kp; i += kThreads) {
      const int p = i / kp, k = i - p * kp;
      const float v = (p < pc && k < K) ? a.d[(size_t)(p0 + p) * K + k] : 0.f;
      s_d[p * ld + k] = __float2bfloat16_rn(v);
    }
  }
  for (int i = tid; i < kRowsBf16 * ld; i += kThreads) s_x[i] = __float2bfloat16_rn(0.f);
  init_rows(a, s_xown, s_ia, s_nih, row0, nrows);

  // Product 1: this warp's 8-wide tiles of p are warp, warp + 8, warp + 16.
  // Ym and M at the accumulator positions: rows grp and grp + 8, columns
  // 2 tig and 2 tig + 1 of each tile; zero outside the problem, so that the
  // residual there is zero.
  const int ntp = pcp / 8;
  const int ntw = ntp > warp ? (ntp - warp + kWarps - 1) / kWarps : 0;  // this warp's tiles
  float ymr[kTilesP][4], mr[kTilesP][4];
#pragma unroll
  for (int t = 0; t < kTilesP; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = grp + 8 * (i >> 1);
      const int p = (warp + kWarps * t) * 8 + 2 * tig + (i & 1);
      const bool ok = r < nrows && p < pc;
      mr[t][i] = ok ? a.m[(size_t)(row0 + r) * a.P + p0 + p] : 0.f;
      ymr[t][i] = ok ? mr[t][i] * a.y[(size_t)(row0 + r) * a.P + p0 + p] : 0.f;
    }
  }
  // Product 2: this warp's 16-wide tiles of k are contiguous.
  const int npk = kp / 16;
  const int ppw = (npk + kWarps - 1) / kWarps;
  const int pk0 = min(npk, warp * ppw);
  const int npw = min(ppw, npk - pk0);  // this warp's tiles
  cluster.sync();

  int cur = 0;
  PhaseClock clock;
  clock.begin();
  for (int it = 0; it < a.n_iter; ++it) {
    // 1. pred = x D_c^T on the tensor cores, then r = Ym - M * pred as bf16.
    {
      float acc[kTilesP][4];
#pragma unroll
      for (int t = 0; t < kTilesP; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
      const __nv_bfloat16* a_ptr = s_x + (lane & 15) * ld + 8 * (lane >> 4);
      // B for two k steps at once: 8 rows p, the four 8-wide groups of 32 k
      const __nv_bfloat16* b_ptr = s_d + (lane & 7) * ld + 8 * (lane >> 3);
#pragma unroll 2
      for (int k = 0; k < kp; k += 32) {
        uint32_t a0[4], a1[4], bf[kTilesP][4];
        ldmatrix_x4(a0, a_ptr + k);
        ldmatrix_x4(a1, a_ptr + k + 16);
        // all loads first, so that they are in flight together
#pragma unroll
        for (int t = 0; t < kTilesP; ++t)
          if (t < ntw) ldmatrix_x4(bf[t], b_ptr + (warp + kWarps * t) * 8 * ld + k);
#pragma unroll
        for (int t = 0; t < kTilesP; ++t) {
          if (t < ntw) {
            mma_bf16(acc[t], a0, bf[t][0], bf[t][1]);
            mma_bf16(acc[t], a1, bf[t][2], bf[t][3]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kTilesP; ++t) {
        const int tile = warp + kWarps * t;
        if (tile < ntp) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float r0 = ymr[t][2 * h] - mr[t][2 * h] * acc[t][2 * h];
            const float r1 = ymr[t][2 * h + 1] - mr[t][2 * h + 1] * acc[t][2 * h + 1];
            *reinterpret_cast<__nv_bfloat162*>(s_r + (grp + 8 * h) * ldr + tile * 8 + 2 * tig) =
                __floats2bfloat162_rn(r0, r1);
          }
        }
      }
    }
    __syncthreads();
    clock.end(1);

    // 2. partial gradient r_c D_c on the tensor cores; B through ldmatrix.trans.
    {
      float acc[kPairsK][2][4];
#pragma unroll
      for (int j = 0; j < kPairsK; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][h][i] = 0.f;
      const __nv_bfloat16* a_ptr = s_r + (lane & 15) * ldr + 8 * (lane >> 4);
      const __nv_bfloat16* b_ptr = s_d + (lane & 15) * ld + 8 * (lane >> 4);
#pragma unroll 2
      for (int p = 0; p < pcp; p += 16) {
        uint32_t af[4], bf[kPairsK][4];
        ldmatrix_x4(af, a_ptr + p);
#pragma unroll
        for (int j = 0; j < kPairsK; ++j)
          if (j < npw) ldmatrix_x4_trans(bf[j], b_ptr + p * ld + (pk0 + j) * 16);
#pragma unroll
        for (int j = 0; j < kPairsK; ++j) {
          if (j < npw) {
            mma_bf16(acc[j][0], af, bf[j][0], bf[j][1]);
            mma_bf16(acc[j][1], af, bf[j][2], bf[j][3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPairsK; ++j) {
        const int pair = pk0 + j;
        if (j < npw) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = pair * 16 + 8 * h + 2 * tig;
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int r = grp + 8 * v;
              if (r < a.R)
                *reinterpret_cast<float2*>(s_g + r * L.ldg + k) =
                    make_float2(acc[j][h][2 * v], acc[j][h][2 * v + 1]);
            }
          }
        }
      }
    }
    clock.end(2);
    cluster.sync();
    clock.end(3);

    // 3. reduce over the cluster, NLM, new x (rounded to bf16) to every CTA
    reduce_nlm_push(cluster, a, L, s_g, s_gseg, s_xown, s_x, ld, s_ia, s_nih, nrows, cur, clock);
    cur ^= 1;
    cluster.sync();
    clock.end(7);
  }
  write_out(cluster, a, s_xown, row0, nrows, cur);
}

// ----------------------------------------------------------- streamed ----
//
// The kernel for a shape the resident kernels refuse, up to K 1024 (f32) or
// 1280 (bf16): one pass over the CTA's own slice per iteration, the first Pr
// rows resident, the rest streamed through a ring of whole rows (see the
// note at the head).

constexpr int kRowsSt = 16;      // rows of x per cluster in the tiles (R <= 16; the mma's m)
constexpr int kStageBf16 = 16;   // rows of D per stage in bf16: the mma's k in product 2
                                 // (f32: 8 or 16, the plan's stage_rows)
constexpr int kRing = 3;         // stages in the ring: one refilled while two are read
constexpr int kPairsSt = 10;     // bf16 product 2: 16-wide k tiles per warp (K <= 1280)

// Byte offsets in dynamic shared memory.  ops/ista_cuda.py:stream_smem_bytes
// computes the same total.
struct StreamLayout {
  int kp;   // K padded: to 8 floats (f32) or 16 bf16 values
  int ld;   // row stride of x, of the resident rows and of a stage, in elements
  int ldg;  // row stride of the partial gradient, in floats
  int S;    // rows of D per stage: 8 or 16 in f32, 16 in bf16
  int x, dres, ring, part, res, xown, vec, bar, total;
};

__host__ __device__ inline StreamLayout make_stream_layout(int bf16, int R, int K, int seg, int Pr,
                                                           int stages, int S) {
  StreamLayout L;
  const int esz = bf16 ? 2 : 4;
  L.S = S;
  L.kp = bf16 ? round_up(K, 16) : round_up(K, 8);
  L.ld = L.kp + (bf16 ? 8 : 4);  // rows fall into different banks
  L.ldg = L.kp + 8;
  const int xr = bf16 || R > 12 ? kRowsSt : 12;  // rows of x in the tiles (f32: 12 when R <= 12)
  const int bytes_x = xr * L.ld * esz;
  const int bytes_d = round_up(Pr, L.S) * L.ld * esz;
  // the ring; after the pass, the partial gradient in its place
  const int bytes_ring = imax(stages * L.S * L.ld * esz, R * L.ldg * 4);
  const int bytes_part = 2 * (bf16 ? kWarps : 2 * kWarps) * xr * L.S * 4;  // product 1 per consumer warp, two stages
  const int bytes_res = bf16 ? 2 * kRowsSt * (L.S + 8) * 2 : 2 * L.S * kRowsSt * 4;
  const int bytes_gseg = R * (seg + 2 * kHalo) * 4;  // step 3, in place of both
  L.x = 0;
  L.dres = L.x + round_up(bytes_x, 16);
  L.ring = L.dres + round_up(bytes_d, 16);
  L.part = L.ring + round_up(bytes_ring, 16);
  L.res = L.part + round_up(bytes_part, 16);
  L.xown = L.part + imax(round_up(bytes_part, 16) + round_up(bytes_res, 16), round_up(bytes_gseg, 16));
  L.vec = L.xown + round_up(2 * R * seg * 4, 16);
  L.bar = L.vec + 2 * kRowsSt * 4;  // two mbarriers per ring slot: full and empty
  L.total = L.bar + 2 * kRing * 8;
  return L;
}

struct StreamArgs {
  Args a;
  const void* rows;  // the source of the streamed rows: D itself (f32, K % 4 == 0) or its copy
  int rows_ld;       // their row stride in elements: K, or kp for the copy
  int Pr;            // rows of each slice kept resident (a multiple of S, or the whole slice)
  int stages;        // stages of the ring (0: nothing streamed)
};

// Whether the launch first copies D for the streamed rows: bf16 streams a
// copy rounded once per launch (half the bytes of each row), and f32 with K
// not a multiple of 4 a copy whose rows are padded to 16 bytes, the bulk
// copies' alignment.
inline bool stream_copies_d(int bf16, int K) { return bf16 || K % 4 != 0; }

// D into the rows' copy, padded with zeros to kp columns (bf16: rounded).
template <typename T>
__global__ void __launch_bounds__(kThreads) copy_d_rows(const float* d, T* out, int P, int K, int kp) {
  const size_t n = (size_t)P * kp;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += (size_t)gridDim.x * kThreads) {
    const int p = (int)(i / kp), k = (int)(i - (size_t)p * kp);
    const float v = k < K ? d[(size_t)p * K + k] : 0.f;
    if constexpr (std::is_same<T, float>::value)
      out[i] = v;
    else
      out[i] = __float2bfloat16_rn(v);
  }
}

// Bulk copies (the TMA's one-dimensional form) completing on an mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier writes to shared memory before later bulk
// copies into it (the copies write through the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kNT>
__device__ __forceinline__ void zero16(void* p, int bytes) {
  float4* q = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += kNT) q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Threads of a streamed CTA: the consumers, which compute, and one producer
// warp, which issues the bulk copies of the streamed rows (a warp that
// issues them waits until the copy engine takes each, about the time the
// rows take to arrive, and would hold up the consumers' barrier).  f32 runs
// 16 consumer warps (at most 120 registers a thread), so that each
// scheduler has four to hide the latency of the operand loads; bf16 runs 8
// (its product 2 keeps 80 accumulators a thread).
template <bool kBf16>
__host__ __device__ constexpr int stream_consumers() { return kBf16 ? kThreads : 2 * kThreads; }
template <bool kBf16>
__host__ __device__ constexpr int stream_threads() { return stream_consumers<kBf16>() + 32; }

// The consumers' barrier (named barrier 1; the producer warp is not in it).
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

template <bool kBf16, int kS, int kRT>
__global__ void __launch_bounds__(stream_threads<kBf16>()) pnp_ista_stream(const StreamArgs sa) {
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  static_assert(kBf16 ? kS == kStageBf16 && kRT == kRowsSt : (kS == 8 || kS == 16) && (kRT == 12 || kRT == 16),
                "stage rows, tile rows");
  constexpr int kNT = stream_threads<kBf16>();     // all threads
  constexpr int kCT = stream_consumers<kBf16>();   // the consumers: warps below kCT / 32
  constexpr int kCW = kCT / 32;
  constexpr int S = kS;
  cg::cluster_group cluster = cg::this_cluster();
  const Args& a = sa.a;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const StreamLayout L = make_stream_layout(kBf16, a.R, a.K, a.seg, sa.Pr, sa.stages, kS);
  T* s_x = reinterpret_cast<T*>(smem + L.x);        // [kRT][ld] operand x
  T* s_dres = reinterpret_cast<T*>(smem + L.dres);  // [Pr][ld] resident rows of the slice
  T* s_ring = reinterpret_cast<T*>(smem + L.ring);  // [stages][S][ld] streamed rows
  float* s_g = reinterpret_cast<float*>(smem + L.ring);     // [R][ldg] partial gradient, after the pass
  float* s_part = reinterpret_cast<float*>(smem + L.part);  // [2][consumer warps][S kRT] product 1 per warp
  char* s_res = smem + L.res;                               // [2] residual of a stage
  float* s_gseg = reinterpret_cast<float*>(smem + L.part);  // [R][seg + 8] in step 3
  float* s_xown = reinterpret_cast<float*>(smem + L.xown);  // [2][R][seg] carried x
  float* s_ia = reinterpret_cast<float*>(smem + L.vec);
  float* s_nih = s_ia + kRowsSt;
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + L.bar);  // [kRing] a slot's rows arrived
  uint64_t* s_empty = s_full + kRing;                             // [kRing] a slot's rows read

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = cluster.block_rank();
  const int cluster_id = blockIdx.x / cluster.num_blocks();
  const int row0 = cluster_id * a.R;
  const int nrows = min(a.R, a.nB - row0);
  const int P = a.P, K = a.K, kp = L.kp, ld = L.ld, NS = sa.stages;
  const int p0 = min(P, rank * a.Pc);
  const int pc = min(P, p0 + a.Pc) - p0;     // this CTA's rows of D
  const int pres = min(pc, sa.Pr);           // of them resident
  const int nres = (pres + S - 1) / S;       // resident stages, then streamed ones
  const int nstr = (pc - pres + S - 1) / S;
  const int nst = nres + nstr;
  const int nq = kp / 4;                     // float4 columns of K
  // Streamed rows arrive by bulk copies, a row each, which the producer warp
  // issues (the rows of their source are 16-byte aligned).
  const int row_bytes = sa.rows_ld == K && !kBf16 ? K * 4 : kp * (int)sizeof(T);

  // The resident rows (bf16: rounded), zero past the slice and past K; x = 0.
  const int prp = round_up(sa.Pr, S);
  for (int i = tid; i < prp * nq; i += kNT) {
    const int p = i / nq, k = 4 * (i - p * nq);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < pres) {
      const float* src = a.d + (size_t)(p0 + p) * K + k;
      if (K % 4 == 0) {
        if (k < K) v = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        v.x = k < K ? __ldg(src) : 0.f;
        v.y = k + 1 < K ? __ldg(src + 1) : 0.f;
        v.z = k + 2 < K ? __ldg(src + 2) : 0.f;
        v.w = k + 3 < K ? __ldg(src + 3) : 0.f;
      }
    }
    store_operand4(s_dres + p * ld + k, v);
  }
  zero16<kNT>(s_x, round_up(kRT * ld * (int)sizeof(T), 16));
  // The ring starts at zero, and the partial gradient's place in it is
  // zeroed again after each step 3: a bulk copy writes K values of a row
  // (f32) and only the rows of the slice, so the rest of a slot keeps what
  // it held.  That must be zero or rows of D, never a partial gradient's
  // bits: read as bf16, some of them are Inf or NaN, and product 1 meets
  // them (0 * NaN is NaN, which product 2 spreads over every column).
  zero16<kNT>(s_ring, L.part - L.ring);
  fence_proxy_async();
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(s_full + i, 1);
      mbar_init(s_empty + i, kCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  init_rows<kNT>(a, s_xown, s_ia, s_nih, row0, nrows);

  // The rows of stage j: resident, or a slot of the ring.
  auto stage_rows = [&](int j) -> const T* {
    return j < nres ? s_dres + (size_t)j * S * ld : s_ring + (size_t)((j - nres) % NS) * S * ld;
  };
  // The residual: the last nout consumers finish one element (rr, pp) of a
  // stage's kRT x S each (f32: the tiles' rows, 12 of them when R <= 12).
  constexpr int kShares = kCW;  // product 1: the consumer warps split K
  constexpr int nout = kRT * S;
  const int tr = tid - (kCT - nout);  // in [0, nout): this thread finishes an element
  const int rr = kBf16 ? tr >> 4 : tr % kRT;
  const int pp = kBf16 ? tr & 15 : tr / kRT;

  // f32 product 1: warp w takes share w of the float4 columns of K; lane
  // tile of rows rg + 4i (i < kRT / 4) and stage rows pg + 4j (j < S / 4),
  // the two half-warps (kk) taking alternate columns of the share.
  const int kk = lane >> 4, rg = (lane >> 2) & 3, pg = lane & 3;
  const int qpw = (nq + kShares - 1) / kShares;
  const int qa = min(nq, warp * qpw), qb = min(nq, qa + qpw);
  // f32 product 2: rpt rows of the partial gradient by one float4 column per
  // thread, in registers for the whole pass (512 consumers: kRT / 4 rows up
  // to 128 columns of float4, in stages of 16 rows; kRT / 2 up to 256, in
  // stages of 8).
  constexpr int kMaxRpt = kS == 16 ? kRT / 4 : kRT / 2;
  // The f32 residual keeps kG rows to a float4 of each 16-float row (kRT 12:
  // rows 3h .. 3h + 2 at 4h .. 4h + 2), so that product 2 loads a thread's
  // rows 4 or 3 at a time.
  constexpr int kG = kRT == 16 ? 4 : 3;
  auto kG_slot = [](int r) { return r / kG * 4 + r % kG; };
  const int groups = nq <= kCT / 4 ? 4 : 2;  // of rows, each over kCT / groups columns
  const int rpt = kRT / groups;
  const int qt = tid % (kCT / groups), rb = tid / (kCT / groups) * rpt;
  // bf16: the mma fragments' row and column pair; product 1's k steps per
  // warp; product 2's 16-wide k tiles per warp.
  const int grp = lane >> 2, tig = lane & 3;
  const int nks = kp / 16, ksw = (nks + kCW - 1) / kCW;
  const int ka = min(nks, warp * ksw), kb = min(nks, ka + ksw);
  const int npk = kp / 16, ppw = (npk + kCW - 1) / kCW;
  const int pk0 = min(npk, warp * ppw), npw = min(ppw, npk - pk0);

  float4 gacc[kMaxRpt];          // f32 product 2
  float gmma[kPairsSt][2][4];    // bf16 product 2
  Layout Lg;
  Lg.ldg = L.ldg;
  // bit i: the phase of slot i's full (consumers) or empty (producer)
  // mbarrier to wait for next; the producer's slots filled at least once
  uint32_t full_parity = 0, empty_parity = 0, filled = 0;
  cluster.sync();

  int cur = 0;
  PhaseClock clock;
  clock.begin();
  for (int it = 0; it < a.n_iter; ++it) {
    if (tid >= kCT) {
      // The producer: every streamed stage of the pass in order, each into
      // its slot once the consumers have read what the slot held.
      for (int s = 0; s < nstr; ++s) {
        const int slot = s % NS;
        if ((filled >> slot) & 1u) {
          mbar_wait(s_empty + slot, (empty_parity >> slot) & 1u);
          empty_parity ^= 1u << slot;
        }
        filled |= 1u << slot;
        T* dst = s_ring + (size_t)slot * S * ld;
        const int pb = pres + s * S;
        const int nvalid = min(S, pc - pb);
        if (lane == 0) mbar_expect_tx(s_full + slot, nvalid * row_bytes);
        __syncwarp();
        if (lane < nvalid)
          bulk_copy(dst + lane * ld,
                    static_cast<const T*>(sa.rows) + (size_t)(p0 + pb + lane) * sa.rows_ld, row_bytes,
                    s_full + slot);
      }
    } else {
      if constexpr (kBf16) {
#pragma unroll
        for (int j = 0; j < kPairsSt; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) gmma[j][h][i] = 0.f;
      } else {
#pragma unroll
        for (int i = 0; i < kMaxRpt; ++i) gacc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float ymv = 0.f, mv = 0.f;  // Ym and M of this thread's residual element, stage in flight

      // Step j: product 2 of stage j - 2 (then its slot is released), the
      // residual of stage j - 1, product 1 of stage j.  One barrier of the
      // consumers per step; a stage's rows are read in steps j and j + 2, so a
      // ring of three slots has a step to fill the one released.
      for (int j = 0; nst > 0 && j < nst + 2; ++j) {
        if (j >= nres && j < nst) {
          const int slot = (j - nres) % NS;
          mbar_wait(s_full + slot, (full_parity >> slot) & 1u);
          full_parity ^= 1u << slot;
        }
        consumer_sync(kCT);
        clock.end(3);

        if (j >= 2) {
          const T* src = stage_rows(j - 2);
          if constexpr (kBf16) {
            // g[16][K] += r[16][16] D[16][K] on the tensor cores, B through ldmatrix.trans
            const __nv_bfloat16* res = reinterpret_cast<const __nv_bfloat16*>(s_res) +
                                       (j & 1) * kRowsSt * (kStageBf16 + 8);
            uint32_t af[4];
            ldmatrix_x4(af, res + (lane & 15) * (kStageBf16 + 8) + 8 * (lane >> 4));
            const T* b_ptr = src + (lane & 15) * ld + 8 * (lane >> 4);
#pragma unroll
            for (int jj = 0; jj < kPairsSt; ++jj) {
              if (jj < npw) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, b_ptr + (pk0 + jj) * 16);
                mma_bf16(gmma[jj][0], af, bf[0], bf[1]);
                mma_bf16(gmma[jj][1], af, bf[2], bf[3]);
              }
            }
          } else if (qt < nq) {
            // g[rb .. rb + rpt)[4 qt .. 4 qt + 4) += r D over the stage's rows in order
            const float* res = reinterpret_cast<const float*>(s_res) + (j & 1) * 16 * S;  // [S][16]
            const float4* dcol = reinterpret_cast<const float4*>(src) + qt;
            const int ld4 = ld / 4;
#pragma unroll 4
            for (int p = 0; p < S; ++p) {
              const float4 dv = dcol[p * ld4];
              // the residual of rows rb .. rb + rpt at p, kG rows to a
              // float4 (broadcasts)
              float rv[kMaxRpt];
              const float4* rp = reinterpret_cast<const float4*>(res + p * 16) + rb / kG;
#pragma unroll
              for (int h = 0; h < kMaxRpt / kG; ++h) {
                if (h * kG < rpt) {
                  const float4 v = rp[h];
                  rv[kG * h] = v.x;
                  rv[kG * h + 1] = v.y;
                  rv[kG * h + 2] = v.z;
                  if constexpr (kG == 4) rv[kG * h + 3] = v.w;
                }
              }
#pragma unroll
              for (int i = 0; i < kMaxRpt; ++i) {
                if (i < rpt) {
                  float4& o = gacc[i];
                  o.x = fmaf(rv[i], dv.x, o.x);
                  o.y = fmaf(rv[i], dv.y, o.y);
                  o.z = fmaf(rv[i], dv.z, o.z);
                  o.w = fmaf(rv[i], dv.w, o.w);
                }
              }
            }
          }
          if (j - 2 >= nres) {  // the stage's slot, read by this warp for the last time
            __syncwarp();
            if (lane == 0) mbar_arrive(s_empty + (j - 2 - nres) % NS);
          }
        }
        clock.end(2);

        if (j >= 1 && j <= nst && tr >= 0) {
          // the warps' partial sums of stage j - 1 in warp order
          const float* part = s_part + ((j - 1) & 1) * kShares * kRT * S;
          float pred = 0.f;
          const int e = kBf16 ? rr * 16 + pp : pp * kRT + rr;
#pragma unroll
          for (int w = 0; w < kShares; ++w) pred += part[w * kRT * S + e];
          const float res = ymv - mv * pred;
          if constexpr (kBf16)
            reinterpret_cast<__nv_bfloat16*>(s_res)[((j - 1) & 1) * kRowsSt * (kStageBf16 + 8) +
                                                    rr * (kStageBf16 + 8) + pp] = __float2bfloat16_rn(res);
          else
            reinterpret_cast<float*>(s_res)[((j - 1) & 1) * 16 * S + pp * 16 + kG_slot(rr)] = res;
        }
        clock.end(1);


        if (j < nst) {
          ymv = mv = 0.f;
          if (tr >= 0 && rr < nrows && j * S + pp < pc) {
            const size_t at = (size_t)(row0 + rr) * P + p0 + j * S + pp;
            mv = __ldg(a.m + at);
            ymv = mv * __ldg(a.y + at);
          }
          const T* src = stage_rows(j);
          float* part = s_part + (j & 1) * kShares * kRT * S + warp * kRT * S;
          if constexpr (kBf16) {
            // pred[16][16] of this warp's k steps on the tensor cores
            float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            const T* a_ptr = s_x + (lane & 15) * ld + 8 * (lane >> 4);
            const T* b_ptr = src + (((lane >> 4) & 1) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll 2
            for (int ks = ka; ks < kb; ++ks) {
              uint32_t af[4], bf[4];
              ldmatrix_x4(af, a_ptr + 16 * ks);
              ldmatrix_x4(bf, b_ptr + 16 * ks);
              mma_bf16(acc[0], af, bf[0], bf[1]);
              mma_bf16(acc[1], af, bf[2], bf[3]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              *reinterpret_cast<float2*>(part + grp * 16 + nt * 8 + 2 * tig) = make_float2(acc[nt][0], acc[nt][1]);
              *reinterpret_cast<float2*>(part + (grp + 8) * 16 + nt * 8 + 2 * tig) =
                  make_float2(acc[nt][2], acc[nt][3]);
            }
          } else {
            constexpr int kP = S / 4;     // stage rows per lane
            constexpr int kRI = kRT / 4;  // rows of x per lane
            float acc[kRI][kP];
#pragma unroll
            for (int i = 0; i < kRI; ++i)
#pragma unroll
              for (int jp = 0; jp < kP; ++jp) acc[i][jp] = 0.f;
            const int ld4 = ld / 4;
            const float4* x4 = reinterpret_cast<const float4*>(s_x);
            const float4* d0 = reinterpret_cast<const float4*>(src) + pg * ld4;
            // one float4 column at a time: sixteen warps hide the loads' latency
#pragma unroll 1
            for (int q = qa + kk; q < qb; q += 2) {
              float4 u[kP], xv[kRI];
#pragma unroll
              for (int jp = 0; jp < kP; ++jp) u[jp] = d0[4 * jp * ld4 + q];
#pragma unroll
              for (int i = 0; i < kRI; ++i) xv[i] = x4[(rg + 4 * i) * ld4 + q];
              // k in order; neighbouring FMAs go to different accumulators
#pragma unroll
              for (int i = 0; i < kRI; ++i)
#pragma unroll
                for (int jp = 0; jp < kP; ++jp) acc[i][jp] = fmaf(xv[i].x, u[jp].x, acc[i][jp]);
#pragma unroll
              for (int i = 0; i < kRI; ++i)
#pragma unroll
                for (int jp = 0; jp < kP; ++jp) acc[i][jp] = fmaf(xv[i].y, u[jp].y, acc[i][jp]);
#pragma unroll
              for (int i = 0; i < kRI; ++i)
#pragma unroll
                for (int jp = 0; jp < kP; ++jp) acc[i][jp] = fmaf(xv[i].z, u[jp].z, acc[i][jp]);
#pragma unroll
              for (int i = 0; i < kRI; ++i)
#pragma unroll
                for (int jp = 0; jp < kP; ++jp) acc[i][jp] = fmaf(xv[i].w, u[jp].w, acc[i][jp]);
            }
            // the two half-warps' sums, then one per element of the tile
#pragma unroll
            for (int i = 0; i < kRI; ++i)
#pragma unroll
              for (int jp = 0; jp < kP; ++jp) acc[i][jp] += __shfl_xor_sync(0xffffffffu, acc[i][jp], 16);
            if (kk == 0) {
#pragma unroll
              for (int i = 0; i < kRI; ++i)
#pragma unroll
                for (int jp = 0; jp < kP; ++jp) part[(pg + 4 * jp) * kRT + rg + 4 * i] = acc[i][jp];
            }
          }
        }
        clock.end(0);

      }
    }
    // The pass is over (the producer has issued its stages, the consumers
    // have read them): the partial gradient into the ring's place.
    __syncthreads();
    if (tid < kCT) {
      if constexpr (kBf16) {
#pragma unroll
        for (int jj = 0; jj < kPairsSt; ++jj) {
          if (jj < npw) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = (pk0 + jj) * 16 + 8 * h + 2 * tig;
#pragma unroll
              for (int v = 0; v < 2; ++v) {
                const int r = grp + 8 * v;
                if (r < a.R)
                  *reinterpret_cast<float2*>(s_g + r * L.ldg + k) =
                      make_float2(gmma[jj][h][2 * v], gmma[jj][h][2 * v + 1]);
              }
            }
          }
        }
      } else if (qt < nq) {
#pragma unroll
        for (int i = 0; i < kMaxRpt; ++i)
          if (i < rpt && rb + i < a.R) reinterpret_cast<float4*>(s_g + (rb + i) * L.ldg)[qt] = gacc[i];
      }
    }
    fence_proxy_async();  // before the next pass's bulk copies into the ring
    cluster.sync();
    clock.end(7);

    // 3. reduce over the cluster, NLM, new x to every CTA (bf16: rounded)
    reduce_nlm_push<T, kNT>(cluster, a, Lg, s_g, s_gseg, s_xown, s_x, ld, s_ia, s_nih, nrows, cur, clock);
    cur ^= 1;
    cluster.sync();
    if (NS > 0 && it + 1 < a.n_iter) {  // the peers have read s_g: zero it before the next pass's copies
      zero16<kNT>(s_g, a.R * L.ldg * 4);
      fence_proxy_async();
      __syncthreads();
    }
    clock.end(7);
  }
  write_out<kNT>(cluster, a, s_xown, row0, nrows, cur);
}

// ------------------------------------------------------------- column ----
//
// The long-K tail (see the note at the head): CTA c of a cluster owns the
// columns [k0, k0 + seg) of x and of D for all P rows, and the rows
// [c Pc, (c + 1) Pc) of the residual in the reduction between the products.

constexpr int kColThreadsF32 = 2 * kThreads;  // f32: 16 warps
constexpr int kColPairs = 4;                  // bf16 product 2: 16-wide column tiles sharing an A fragment
constexpr int kColChunk = 8;                  // bf16 products 1 and 2: k steps per mma chain (see there)
constexpr int kColSplitSteps = 32;            // bf16 product 2: the fewest p steps it splits over (see there)

// Byte offsets in dynamic shared memory.  ops/ista_cuda.py:column_smem_bytes
// computes the same total.
struct ColumnLayout {
  int ldw;     // row stride of the resident rows (bf16: and of the operand x), in elements
  int pp;      // P padded to 16: the bf16 residual's columns, the transposed copy's row stride
  int nqt;     // f32 product 2: threads per group of rows of D, a float4 column each
  int groups;  // f32 product 2: groups of rows of D, their sums added in order after the pass
  int d, x, xown, buf, res, g, vec, total;
};

// RT: rows of the f32 register tiles (4 or 12; bf16: the mma's 16).
__host__ __device__ inline ColumnLayout make_column_layout(int bf16, int R, int RT, int P, int seg, int Pr) {
  ColumnLayout L;
  L.pp = round_up(P, 16);
  int bytes_d, bytes_x, bytes_xown, bytes_buf, bytes_res;
  if (bf16) {
    L.ldw = seg + 8;  // rows fall into different banks for ldmatrix
    L.nqt = 0;
    L.groups = 1;
    bytes_d = round_up(Pr, 16) * L.ldw * 2;
    bytes_x = kRowsBf16 * L.ldw * 2;
    bytes_xown = R * seg * 4;                 // the carried x in f32
    bytes_buf = R * imax(L.pp, seg) * 4;      // partial pred [R][pp]; product 2's odd half [R][seg]
    bytes_res = kRowsBf16 * (L.pp + 8) * 2;   // the residual [16][pp + 8]
  } else {
    L.ldw = seg + 4;  // seg is a multiple of 8: consecutive rows fall into different banks
    L.nqt = seg / 4 < kColThreadsF32 ? seg / 4 : kColThreadsF32;
    L.groups = kColThreadsF32 / L.nqt;
    bytes_d = Pr * L.ldw * 4;
    bytes_x = RT * seg * 4;                   // the carried x is the operand
    bytes_xown = 0;
    // partial pred, then the residual, [P][RT]; after product 2 the groups'
    // partial gradients [groups][R][seg] in their place
    bytes_buf = imax(P * RT, L.groups > 1 ? L.groups * R * seg : 0) * 4;
    bytes_res = 0;
  }
  L.d = 0;
  L.x = L.d + round_up(bytes_d, 16);
  L.xown = L.x + round_up(bytes_x, 16);
  L.buf = L.xown + round_up(bytes_xown, 16);
  L.res = L.buf + round_up(bytes_buf, 16);
  L.g = L.res + round_up(bytes_res, 16);
  L.vec = L.g + round_up(R * (seg + 2 * kHalo) * 4, 16);
  L.total = L.vec + 2 * kRowsBf16 * 4;
  return L;
}

inline int column_tile_rows(int bf16, int R) { return bf16 ? kRowsBf16 : R <= 4 ? 4 : 12; }

struct ColumnArgs {
  Args a;
  const void* rows;           // D's rows (f32: D itself when K % 4 == 0, else its padded
                              // copy; bf16: the rounded copy), row stride rows_ld
  int rows_ld;
  const __nv_bfloat16* cols;  // bf16: the rounded transposed copy [round_up(K, 16)][pp]
  int Pr;                     // rows of D[:, k_c] kept in shared memory (bf16: a multiple of 16, or P)
};

// Whether a launch of the column kernels first copies D: f32 pads rows
// whose K is not a multiple of 4 to 16 bytes; bf16 rounds D and its
// transpose for the rows it does not keep.
inline bool column_copies_d(int bf16, int K, int P, int Pr) { return bf16 ? Pr < P : K % 4 != 0; }

// D^T rounded to bf16, [kp][pp], zero past K and P.
__global__ void __launch_bounds__(kThreads) copy_dt_rows(const float* d, __nv_bfloat16* out, int P, int K,
                                                         int kp, int pp) {
  const size_t n = (size_t)kp * pp;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += (size_t)gridDim.x * kThreads) {
    const int k = (int)(i / pp), p = (int)(i - (size_t)k * pp);
    out[i] = __float2bfloat16_rn(k < K && p < P ? d[(size_t)p * K + k] : 0.f);
  }
}

// The NLM at column k of a row whose gradient step g is known at the
// columns that reflect_index(k - 4 .. k + 4, K) names.
__device__ __forceinline__ float nlm_point(const float* g, int k, int K, float nh) {
  float v[9];  // v[4 + j] = padded g at offset j from k
  if (k >= kHalo && k + kHalo < K) {  // inside: no reflection
#pragma unroll
    for (int j = -4; j <= 4; ++j) v[4 + j] = g[k + j];
  } else {
#pragma unroll
    for (int j = -4; j <= 4; ++j) v[4 + j] = g[reflect_index(k + j, K)];
  }
  float num = 8.f * v[4];
  float den = 8.f;
#pragma unroll
  for (int delta = 1; delta <= 3; ++delta) {
    float p = v[3] - v[3 + delta], q = v[4] - v[4 + delta], s = v[5] - v[5 + delta];
    const float wf = 7.f * expf(3.f * (p * p + q * q + s * s) * nh);
    num += wf * v[4 + delta];
    den += wf;
    p = v[3 - delta] - v[3];
    q = v[4 - delta] - v[4];
    s = v[5 - delta] - v[5];
    const float wb = 7.f * expf(3.f * (p * p + q * q + s * s) * nh);
    num += wb * v[4 - delta];
    den += wb;
  }
  return num / den;
}

// 1/alpha and -1/(9 h^2) of the cluster's rows, with the clamps of the plain version.
__device__ __forceinline__ void row_scalars(const Args& a, float* s_ia, float* s_nih, int row0, int nrows) {
  const int tid = threadIdx.x;
  if (tid < kRowsBf16) {
    float ia = 0.f, nih = -1.f;
    if (tid < nrows) {
      const float alpha = fmaxf(a.alpha[row0 + tid], 1e-12f);
      const float h = a.h_coef / (2.0f * alpha);
      ia = 1.0f / alpha;
      nih = -1.0f / fmaxf(h * h * 9.0f, 1e-30f);
    }
    s_ia[tid] = ia;
    s_nih[tid] = nih;
  }
}

// The halo of the CTA's gradient step (4 columns either side, where they
// exist) from its neighbours' s_g, then the NLM on its columns; x_new(r, j,
// value) stores the new x.  Between the third cluster sync of an iteration
// and the next product 1.
template <int kNT, typename Store>
__device__ __forceinline__ void column_halo_nlm(cg::cluster_group& cluster, float* s_g, const float* s_nih,
                                                int K, int seg, int k0, int nk, int nrows, Store x_new) {
  const int tid = threadIdx.x, rank = cluster.block_rank(), ldg = seg + 2 * kHalo;
  if (nk > 0) {
    for (int e = tid; e < nrows * 2 * kHalo; e += kNT) {
      const int r = e / (2 * kHalo), j = e - r * 2 * kHalo;
      if (j < kHalo) {  // column k0 - 4 + j, the left neighbour's column seg - 4 + j
        if (k0 > 0) s_g[r * ldg + j] = cluster.map_shared_rank(s_g, rank - 1)[r * ldg + seg + j];
      } else if (k0 + nk + j - kHalo < K) {  // column k0 + nk + j - 4, the right neighbour's j - 4
        s_g[r * ldg + nk + j] = cluster.map_shared_rank(s_g, rank + 1)[r * ldg + j];
      }
    }
  }
  __syncthreads();
  // two points a thread at a time, both computed before either is stored
  for (int e = tid; e < nrows * nk; e += 2 * kNT) {
    const int e2 = e + kNT < nrows * nk ? e + kNT : e;
    const int r = e / nk, j = e - r * nk, r2 = e2 / nk, j2 = e2 - r2 * nk;
    const float v = nlm_point(s_g + r * ldg + kHalo - k0, k0 + j, K, s_nih[r]);
    const float v2 = nlm_point(s_g + r2 * ldg + kHalo - k0, k0 + j2, K, s_nih[r2]);
    x_new(r, j, v);
    x_new(r2, j2, v2);
  }
  __syncthreads();
}

template <int kRT>
__global__ void __launch_bounds__(kColThreadsF32, 1) pnp_ista_column_f32(const ColumnArgs ca) {
  static_assert(kRT == 4 || kRT == 12, "tile rows");
  constexpr int kNT = kColThreadsF32;
  constexpr int kV = kRT / 4;  // float4 groups of rows
  cg::cluster_group cluster = cg::this_cluster();
  const Args& a = ca.a;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int P = a.P, K = a.K, R = a.R, seg = a.seg;
  const ColumnLayout L = make_column_layout(0, R, kRT, P, seg, ca.Pr);
  float* s_d = reinterpret_cast<float*>(smem + L.d);      // [Pr][ldw] resident rows of D[:, k_c]
  float* s_x = reinterpret_cast<float*>(smem + L.x);      // [kRT][seg] x of the CTA's columns
  float* s_buf = reinterpret_cast<float*>(smem + L.buf);  // [P][kRT] partial pred, then the residual
  float* s_part = s_buf;                                  // [groups][R][seg] after product 2
  float* s_g = reinterpret_cast<float*>(smem + L.g);      // [R][seg + 8] gradient step with its halo
  float* s_ia = reinterpret_cast<float*>(smem + L.vec);
  float* s_nih = s_ia + kRowsBf16;

  const int tid = threadIdx.x;
  const int C = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int row0 = blockIdx.x / C * R;
  const int nrows = min(R, a.nB - row0);
  const int k0 = min(K, rank * seg), nk = min(K, k0 + seg) - k0;
  const int nq = (nk + 3) / 4;   // float4 columns (a padded copy where K % 4 != 0)
  const int sq = seg / 4;
  const int pa = min(P, rank * a.Pc), pb = min(P, pa + a.Pc);  // the CTA's rows of the residual
  const int pres = min(P, ca.Pr);
  const int ldw = L.ldw, ldg = seg + 2 * kHalo;
  const float* rows = static_cast<const float*>(ca.rows) + k0;
  const size_t rows_ld = ca.rows_ld;

  for (int i = tid; i < pres * sq; i += kNT) {
    const int p = i / sq, q = i - p * sq;
    const float4 v = q < nq ? __ldg(reinterpret_cast<const float4*>(rows + p * rows_ld) + q)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(s_d + p * ldw)[q] = v;
  }
  zero16<kNT>(s_x, kRT * seg * 4);
  zero16<kNT>(s_g, R * ldg * 4);
  row_scalars(a, s_ia, s_nih, row0, nrows);
  cluster.sync();

  // product 1: groups of kLanes lanes, a row of D each; its rows resident or
  // in L2 (4 lanes a row measured no faster: scripts/profile_b1_phases.py)
  constexpr int kLanes = 8;
  static_assert(kLanes >= kV && 32 % kLanes == 0, "lanes per row");
  constexpr int kGroups = kNT / kLanes;
  const int lane8 = tid % kLanes, grp8 = tid / kLanes;
  const int warp_group0 = (tid >> 5) * (32 / kLanes);  // the warp's first group
  auto row_ptr = [&](int p) -> const float4* {
    return p < pres ? reinterpret_cast<const float4*>(s_d + p * ldw)
                    : reinterpret_cast<const float4*>(rows + p * rows_ld);
  };
  // product 2: thread (qt, pg) sums the rows of group pg for float4 column qt
  const int G = L.groups, nqt = L.nqt, Pg = (P + G - 1) / G;
  const int qt = tid % nqt, pg = tid / nqt;
  const int ga = min(P, pg * Pg), gb = min(P, ga + Pg);
  const float4* x4 = reinterpret_cast<const float4*>(s_x);

  PhaseClock clock;
  clock.begin();
  for (int it = 0; it < a.n_iter; ++it) {
    // 1. partial pred[p][r] = x[r, k_c] . D[p, k_c] for every p: group g of
    // kLanes lanes takes rows g and g + kGroups of each 2 kGroups (resident or
    // from L2), lane s of it the float4 columns s, s + kLanes, ... in order
    // for all kRT rows of x, two steps of loads in flight; the lanes' sums
    // added by a butterfly.
    for (int base = 0; base < P; base += 2 * kGroups) {
      if (base + warp_group0 >= P) continue;  // no row for this warp (the same for all its lanes)
      const int p0 = base + grp8, p1 = p0 + kGroups;
      const float4* d0 = row_ptr(p0 < P ? p0 : 0);
      const float4* d1 = row_ptr(p1 < P ? p1 : 0);
      float acc[2][kRT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) acc[0][r] = acc[1][r] = 0.f;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 na0 = lane8 < nq ? d0[lane8] : zero, nb0 = lane8 < nq ? d1[lane8] : zero;
      float4 na1 = lane8 + kLanes < nq ? d0[lane8 + kLanes] : zero;
      float4 nb1 = lane8 + kLanes < nq ? d1[lane8 + kLanes] : zero;
      for (int q = lane8; q < nq; q += kLanes) {
        const float4 da = na0, db = nb0;
        na0 = na1;
        nb0 = nb1;
        if (q + 2 * kLanes < nq) {
          na1 = d0[q + 2 * kLanes];
          nb1 = d1[q + 2 * kLanes];
        }
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const float4 xv = x4[r * sq + q];
          acc[0][r] = fmaf(xv.x, da.x, acc[0][r]);
          acc[0][r] = fmaf(xv.y, da.y, acc[0][r]);
          acc[0][r] = fmaf(xv.z, da.z, acc[0][r]);
          acc[0][r] = fmaf(xv.w, da.w, acc[0][r]);
          acc[1][r] = fmaf(xv.x, db.x, acc[1][r]);
          acc[1][r] = fmaf(xv.y, db.y, acc[1][r]);
          acc[1][r] = fmaf(xv.z, db.z, acc[1][r]);
          acc[1][r] = fmaf(xv.w, db.w, acc[1][r]);
        }
      }
#pragma unroll
      for (int m = 1; m < kLanes; m <<= 1)
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          acc[0][r] += __shfl_xor_sync(0xffffffffu, acc[0][r], m);
          acc[1][r] += __shfl_xor_sync(0xffffffffu, acc[1][r], m);
        }
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        if (lane8 == v) {
          if (p0 < P)
            reinterpret_cast<float4*>(s_buf + p0 * kRT)[v] =
                make_float4(acc[0][4 * v], acc[0][4 * v + 1], acc[0][4 * v + 2], acc[0][4 * v + 3]);
          if (p1 < P)
            reinterpret_cast<float4*>(s_buf + p1 * kRT)[v] =
                make_float4(acc[1][4 * v], acc[1][4 * v + 1], acc[1][4 * v + 2], acc[1][4 * v + 3]);
        }
      }
    }
    clock.end(0);
    cluster.sync();
    clock.end(1);

    // 2. the residual of the CTA's rows: the C partials summed in ring order
    // from the CTA's successor, r = Ym - M pred, into every CTA's s_buf in
    // place of its partial (4 rows of x at a time).
    for (int e = tid; e < (pb - pa) * kV; e += kNT) {
      const int p = pa + e / kV, v = e - (e / kV) * kV;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int i = 0; i < C; ++i) {
        const int c = (rank + 1 + i) & (C - 1);
        const float4 w = reinterpret_cast<const float4*>(cluster.map_shared_rank(s_buf, c) + p * kRT)[v];
        s.x += w.x;
        s.y += w.y;
        s.z += w.z;
        s.w += w.w;
      }
      float res[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * v + j;
        if (r < nrows) {
          const size_t at = (size_t)(row0 + r) * P + p;
          const float mv = __ldg(a.m + at);
          res[j] = mv * __ldg(a.y + at) - mv * res[j];
        } else {
          res[j] = 0.f;
        }
      }
      const float4 out = make_float4(res[0], res[1], res[2], res[3]);
#pragma unroll 8
      for (int i = 0; i < C; ++i) {
        const int c = (rank + 1 + i) & (C - 1);
        reinterpret_cast<float4*>(cluster.map_shared_rank(s_buf, c) + p * kRT)[v] = out;
      }
    }
    clock.end(2);
    cluster.sync();
    clock.end(3);

    // 3. the gradient step of the CTA's columns, g = x + (r D[:, k_c]) / alpha:
    // each thread kRT rows by one float4 column over its group's rows of D in
    // order (resident first); the groups' sums added in order.
    float4 acc[kRT];
    auto gradient = [&](int q, int r, float4 s) {  // g of rows r, columns 4q .. 4q + 3
      const float ia = s_ia[r];
      const float4 xv = x4[r * sq + q];
      float* g = s_g + r * ldg + kHalo + 4 * q;
      const float gv[4] = {xv.x + s.x * ia, xv.y + s.y * ia, xv.z + s.z * ia, xv.w + s.w * ia};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * q + j < nk) g[j] = gv[j];
    };
    for (int q = qt; pg < G && q < nq; q += nqt) {
#pragma unroll
      for (int r = 0; r < kRT; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      auto rows_of = [&](int p, float4 dv) {
        const float4* rp = reinterpret_cast<const float4*>(s_buf + p * kRT);
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const float4 rv = rp[v];
          const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float4& o = acc[4 * v + j];
            o.x = fmaf(rr[j], dv.x, o.x);
            o.y = fmaf(rr[j], dv.y, o.y);
            o.z = fmaf(rr[j], dv.z, o.z);
            o.w = fmaf(rr[j], dv.w, o.w);
          }
        }
      };
      // the group's rows in order: resident ones, then from L2 with the next row's load in flight
      const int gr = min(gb, max(ga, pres));
#pragma unroll 4
      for (int p = ga; p < gr; ++p) rows_of(p, reinterpret_cast<const float4*>(s_d + p * ldw)[q]);
      if (gr < gb) {
        const float4* src = reinterpret_cast<const float4*>(rows) + q;
        const size_t ld4 = rows_ld / 4;
        float4 nd = __ldg(src + gr * ld4);
#pragma unroll 4
        for (int p = gr; p < gb; ++p) {
          const float4 dv = nd;
          if (p + 1 < gb) nd = __ldg(src + (p + 1) * ld4);
          rows_of(p, dv);
        }
      }
      if (G == 1) {
#pragma unroll
        for (int r = 0; r < kRT; ++r)
          if (r < nrows) gradient(q, r, acc[r]);
      }
    }
    if (G > 1) {
      __syncthreads();  // every read of the residual is done: the partials take its place
      if (pg < G && qt < nq) {
#pragma unroll
        for (int r = 0; r < kRT; ++r)
          if (r < R) reinterpret_cast<float4*>(s_part + (pg * R + r) * seg)[qt] = acc[r];
      }
      __syncthreads();
      for (int e = tid; e < nrows * nq; e += kNT) {
        const int r = e / nq, q = e - r * nq;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = 0; i < G; ++i) {
          const float4 w = reinterpret_cast<const float4*>(s_part + (i * R + r) * seg)[q];
          s.x += w.x;
          s.y += w.y;
          s.z += w.z;
          s.w += w.w;
        }
        gradient(q, r, s);
      }
    }
    clock.end(4);
    cluster.sync();
    clock.end(5);

    // 4. the halo, the NLM, the new x in place
    column_halo_nlm<kNT>(cluster, s_g, s_nih, K, seg, k0, nk, nrows,
                         [&](int r, int j, float v) { s_x[r * seg + j] = v; });
    clock.end(6);
  }
  cluster.sync();  // no peer reads this CTA's shared memory after this
  for (int e = tid; e < nrows * nk; e += kNT) {
    const int r = e / nk, j = e - r * nk;
    a.out[(size_t)(row0 + r) * K + k0 + j] = s_x[r * seg + j];
  }
}

__global__ void __launch_bounds__(kThreads, 1) pnp_ista_column_bf16(const ColumnArgs ca) {
  constexpr int kNT = kThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const Args& a = ca.a;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int P = a.P, K = a.K, R = a.R, seg = a.seg;
  const ColumnLayout L = make_column_layout(1, R, kRowsBf16, P, seg, ca.Pr);
  __nv_bfloat16* s_d = reinterpret_cast<__nv_bfloat16*>(smem + L.d);  // [Pr padded to 16][ldw]
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem + L.x);  // [16][ldw] operand x
  float* s_xown = reinterpret_cast<float*>(smem + L.xown);            // [R][seg] carried x
  float* s_pred = reinterpret_cast<float*>(smem + L.buf);             // [R][pp] partial pred
  float* s_half = s_pred;                                             // [R][seg] product 2's odd half
  __nv_bfloat16* s_r = reinterpret_cast<__nv_bfloat16*>(smem + L.res);  // [16][pp + 8] residual
  float* s_g = reinterpret_cast<float*>(smem + L.g);                  // [R][seg + 8] gradient step
  float* s_ia = reinterpret_cast<float*>(smem + L.vec);
  float* s_nih = s_ia + kRowsBf16;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;  // the mma fragments' row and column pair
  const int C = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int row0 = blockIdx.x / C * R;
  const int nrows = min(R, a.nB - row0);
  const int k0 = min(K, rank * seg), nk = min(K, k0 + seg) - k0;
  const int pa = min(P, rank * a.Pc), pb = min(P, pa + a.Pc);  // a.Pc is a multiple of 4
  const int pres = min(P, ca.Pr);
  const int ldw = L.ldw, pp = L.pp, ldr = pp + 8, ldg = seg + 2 * kHalo;
  const int nks = (nk + 15) / 16;   // product 1's k steps, product 2's 16-wide column tiles
  const int npt = pp / 16;          // product 1's 16-row tiles of D, product 2's p steps
  const int nrt = ca.Pr >= P ? npt : ca.Pr / 16;  // of them resident
  // the copies, as 32-bit pairs of bf16: rows [P][rows_ld], cols [kp][pp]
  const uint32_t* rows = reinterpret_cast<const uint32_t*>(static_cast<const __nv_bfloat16*>(ca.rows) + k0);
  const int rows_ld2 = ca.rows_ld / 2;
  const uint32_t* cols = reinterpret_cast<const uint32_t*>(ca.cols);
  const int pp2 = pp / 2;

  // The resident rows rounded, zero past P and past nk; x = 0; the residual 0.
  for (int i = tid; i < round_up(ca.Pr, 16) * (seg / 4); i += kNT) {
    const int p = i / (seg / 4), k = 4 * (i - p * (seg / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < pres) {
      const float* src = a.d + (size_t)p * K + k0 + k;
      v.x = k < nk ? __ldg(src) : 0.f;
      v.y = k + 1 < nk ? __ldg(src + 1) : 0.f;
      v.z = k + 2 < nk ? __ldg(src + 2) : 0.f;
      v.w = k + 3 < nk ? __ldg(src + 3) : 0.f;
    }
    store_operand4(s_d + p * ldw + k, v);
  }
  zero16<kNT>(s_x, kRowsBf16 * ldw * 2);
  zero16<kNT>(s_xown, R * seg * 4);
  zero16<kNT>(s_r, kRowsBf16 * ldr * 2);
  zero16<kNT>(s_g, R * ldg * 4);
  row_scalars(a, s_ia, s_nih, row0, nrows);
  cluster.sync();

  const __nv_bfloat16* x_ptr = s_x + (lane & 15) * ldw + 8 * (lane >> 4);
  const __nv_bfloat16* r_ptr = s_r + (lane & 15) * ldr + 8 * (lane >> 4);

  PhaseClock clock;
  clock.begin();
  for (int it = 0; it < a.n_iter; ++it) {
    // 1. partial pred = x[:, k_c] D[:, k_c]^T on the tensor cores, by 16-row
    // tiles of D: warp w takes the tiles read from L2 nrt + w, nrt + w + 8,
    // ... (32-bit loads of the "col" B fragments from the rounded copy, two
    // k steps in flight), then the resident ones nrt - 1 - w, nrt - 9 - w, ...
    // (ldmatrix), so that each warp has its share of both.
    for (int t = warp; t < npt; t += kWarps) {
      const int pt = t < npt - nrt ? nrt + t : npt - 1 - t;
      // the mma accumulates kColChunk k steps at a time into part, and each
      // chunk is added into acc with a rounded f32 add: the tensor cores'
      // accumulation truncates, and over a long chain (K / C up to some
      // 2500 columns) its bias alone flips roundings of the residual
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      auto end_of_chunk = [&](int ks) {
        if ((ks + 1) % kColChunk == 0 || ks + 1 == nks) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[h][i] += part[h][i];
              part[h][i] = 0.f;
            }
        }
      };
      if (pt < nrt) {
        const __nv_bfloat16* b_ptr =
            s_d + (pt * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * ldw + ((lane >> 3) & 1) * 8;
#pragma unroll 2
        for (int ks = 0; ks < nks; ++ks) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, x_ptr + 16 * ks);
          ldmatrix_x4(bf, b_ptr + 16 * ks);
          mma_bf16(part[0], af, bf[0], bf[1]);
          mma_bf16(part[1], af, bf[2], bf[3]);
          end_of_chunk(ks);
        }
      } else {
        // rows pt 16 + grp (+ 8) of the copy; b0: columns 16 ks + 2 tig, b1: + 8
        const int p_lo = pt * 16 + grp, p_hi = p_lo + 8;
        const bool v0 = p_lo < P, v1 = p_hi < P;
        const uint32_t* s0 = rows + (size_t)(v0 ? p_lo : 0) * rows_ld2 + tig;
        const uint32_t* s1 = rows + (size_t)(v1 ? p_hi : 0) * rows_ld2 + tig;
        auto fetch = [&](int ks, uint32_t (&b)[4]) {
          b[0] = v0 && ks < nks ? __ldg(s0 + 8 * ks) : 0u;
          b[1] = v0 && ks < nks ? __ldg(s0 + 8 * ks + 4) : 0u;
          b[2] = v1 && ks < nks ? __ldg(s1 + 8 * ks) : 0u;
          b[3] = v1 && ks < nks ? __ldg(s1 + 8 * ks + 4) : 0u;
        };
        uint32_t nb0[4], nb1[4];
        fetch(0, nb0);
        fetch(1, nb1);
        for (int ks = 0; ks < nks; ++ks) {
          const uint32_t b[4] = {nb0[0], nb0[1], nb0[2], nb0[3]};
#pragma unroll
          for (int i = 0; i < 4; ++i) nb0[i] = nb1[i];
          fetch(ks + 2, nb1);
          uint32_t af[4];
          ldmatrix_x4(af, x_ptr + 16 * ks);
          mma_bf16(part[0], af, b[0], b[1]);
          mma_bf16(part[1], af, b[2], b[3]);
          end_of_chunk(ks);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = pt * 16 + h * 8 + 2 * tig;
        if (grp < R) *reinterpret_cast<float2*>(s_pred + grp * pp + p) = make_float2(acc[h][0], acc[h][1]);
        if (grp + 8 < R) *reinterpret_cast<float2*>(s_pred + (grp + 8) * pp + p) = make_float2(acc[h][2], acc[h][3]);
      }
    }
    clock.end(0);
    cluster.sync();
    clock.end(1);

    // 2. the residual of the CTA's rows, 4 of them at a time: the C partials
    // in ring order from the CTA's successor, r = Ym - M pred rounded to bf16
    // once, into every CTA's operand copy.
    const int nq4 = (pb - pa + 3) / 4;
    for (int e = tid; e < nrows * nq4; e += kNT) {
      const int r = e / nq4, p = pa + 4 * (e - r * nq4);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int i = 0; i < C; ++i) {
        const int c = (rank + 1 + i) & (C - 1);
        const float4 w = *reinterpret_cast<const float4*>(cluster.map_shared_rank(s_pred, c) + r * pp + p);
        s.x += w.x;
        s.y += w.y;
        s.z += w.z;
        s.w += w.w;
      }
      float res[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (p + j < pb) {
          const size_t at = (size_t)(row0 + r) * P + p + j;
          const float mv = __ldg(a.m + at);
          res[j] = mv * __ldg(a.y + at) - mv * res[j];
        } else {
          res[j] = 0.f;
        }
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(res[0], res[1]), hi = __floats2bfloat162_rn(res[2], res[3]);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
#pragma unroll 8
      for (int i = 0; i < C; ++i) {
        const int c = (rank + 1 + i) & (C - 1);
        *reinterpret_cast<uint2*>(cluster.map_shared_rank(s_r, c) + r * ldr + p) = packed;
      }
    }
    clock.end(2);
    cluster.sync();
    clock.end(3);

    // 3. g = x + (r D[:, k_c]) / alpha on the tensor cores.  Warp w takes the
    // 16-wide column tiles w, w + 8, ..., kColPairs of them sharing each A
    // fragment, over the 16-row steps of D in order (resident:
    // ldmatrix.trans; the rest: 32-bit loads of the fragments from the
    // transposed copy in L2, two steps in flight).  Where the CTA has at most
    // 4 kColPairs tiles and P at least kColSplitSteps steps of 16 rows, the
    // warps split into two halves instead: warps 0-3 take the even steps,
    // warps 4-7 the odd ones, warp w of a half the tiles w, w + 4, ...; the
    // odd half's sums go through shared memory and are added to the even
    // half's.  Over fewer steps the exchange costs what the halves save (on
    // an H100 at nB 144, timed against a column kernel that never splits:
    // +8.8% at 9 steps, even at 16 and 25, -8% to -22% from 36 to 57).
    {
      const int halves = nks <= 4 * kColPairs && npt >= kColSplitSteps ? 2 : 1;
      const int half = halves == 2 ? warp >> 2 : 0, wq = halves == 2 ? warp & 3 : warp;
      const int span = kWarps / halves;  // warps over the tiles
      const int ngroups = (nks + span * kColPairs - 1) / (span * kColPairs);  // the same for every warp
      for (int gi = 0; gi < ngroups; ++gi) {
        const int j0 = gi * span * kColPairs + wq;
        int np = 0;  // this warp's tiles in the group
#pragma unroll
        for (int i = 0; i < kColPairs; ++i)
          if (j0 + span * i < nks) np = i + 1;
        // As in product 1, the mma accumulates kColChunk of this half's p
        // steps at a time into part, and each chunk is added into acc with a
        // rounded f32 add: over P / 16 steps uncut (81 at P 1296, about 40 a
        // half) the tensor cores' truncating accumulation flipped bf16
        // roundings of x about twice as often as reorderings of the plain
        // loop's sums (scripts/witness_b1_bf16.py).
        float acc[kColPairs][2][4], part[kColPairs][2][4];
#pragma unroll
        for (int i = 0; i < kColPairs; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][h][v] = part[i][h][v] = 0.f;
        int steps = 0;  // this half's p steps so far
        auto end_of_step = [&]() {
          if (++steps % kColChunk == 0) {
#pragma unroll
            for (int i = 0; i < kColPairs; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                  acc[i][h][v] += part[i][h][v];
                  part[i][h][v] = 0.f;
                }
          }
        };
        if (np > 0) {
#pragma unroll 1
          for (int ps = half; ps < nrt; ps += halves) {
            uint32_t af[4];
            ldmatrix_x4(af, r_ptr + 16 * ps);
            const __nv_bfloat16* b_ptr = s_d + (16 * ps + (lane & 15)) * ldw + 8 * (lane >> 4);
#pragma unroll
            for (int i = 0; i < kColPairs; ++i) {
              if (i < np) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, b_ptr + 16 * (j0 + span * i));
                mma_bf16(part[i][0], af, bf[0], bf[1]);
                mma_bf16(part[i][1], af, bf[2], bf[3]);
              }
            }
            end_of_step();
          }
          const int ps0 = halves == 2 ? nrt + ((half - nrt) & 1) : nrt;  // this half's first step from L2
          if (ps0 < npt) {
            // column k0 + 16 j + 8 h + grp of the transposed copy: b0 at rows 16 ps + 2 tig, b1 + 8
            const uint32_t* src[kColPairs][2];
#pragma unroll
            for (int i = 0; i < kColPairs; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                src[i][h] = cols + (size_t)(k0 + 16 * (i < np ? j0 + span * i : j0) + 8 * h + grp) * pp2 + tig;
            auto fetch = [&](int ps, uint32_t (&b)[kColPairs][2][2]) {
#pragma unroll
              for (int i = 0; i < kColPairs; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  b[i][h][0] = i < np && ps < npt ? __ldg(src[i][h] + 8 * ps) : 0u;
                  b[i][h][1] = i < np && ps < npt ? __ldg(src[i][h] + 8 * ps + 4) : 0u;
                }
            };
            uint32_t nb0[kColPairs][2][2], nb1[kColPairs][2][2];
            fetch(ps0, nb0);
            fetch(ps0 + halves, nb1);
#pragma unroll 1
            for (int ps = ps0; ps < npt; ps += halves) {
              uint32_t b[kColPairs][2][2];
#pragma unroll
              for (int i = 0; i < kColPairs; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  b[i][h][0] = nb0[i][h][0];
                  b[i][h][1] = nb0[i][h][1];
                  nb0[i][h][0] = nb1[i][h][0];
                  nb0[i][h][1] = nb1[i][h][1];
                }
              fetch(ps + 2 * halves, nb1);
              uint32_t af[4];
              ldmatrix_x4(af, r_ptr + 16 * ps);
#pragma unroll
              for (int i = 0; i < kColPairs; ++i) {
                if (i < np) {
                  mma_bf16(part[i][0], af, b[i][0][0], b[i][0][1]);
                  mma_bf16(part[i][1], af, b[i][1][0], b[i][1][1]);
                }
              }
              end_of_step();
            }
          }
        }
        // the last, partial chunk (all of the chain in the uncut build)
#pragma unroll
        for (int i = 0; i < kColPairs; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[i][h][v] += part[i][h][v];
        // the odd half's sums into s_half [R][seg], then the even half adds them
#pragma unroll
        for (int i = 0; i < kColPairs; ++i) {
          if (i < np) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int v = 0; v < 2; ++v) {
                const int r = grp + 8 * v;
                const int col = 16 * (j0 + span * i) + 8 * h + 2 * tig;
                if (half == 1 && r < R)
                  *reinterpret_cast<float2*>(s_half + r * seg + col) =
                      make_float2(acc[i][h][2 * v], acc[i][h][2 * v + 1]);
              }
            }
          }
        }
        if (halves == 2) __syncthreads();
        if (half == 0) {
#pragma unroll
          for (int i = 0; i < kColPairs; ++i) {
            if (i < np) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                  const int r = grp + 8 * v;
                  const int col = 16 * (j0 + span * i) + 8 * h + 2 * tig;
                  if (r < nrows) {
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                      if (col + e < nk)
                        s_g[r * ldg + kHalo + col + e] =
                            s_xown[r * seg + col + e] +
                            (halves == 2 ? acc[i][h][2 * v + e] + s_half[r * seg + col + e] : acc[i][h][2 * v + e]) *
                                s_ia[r];
                  }
                }
              }
            }
          }
        }
        if (halves == 2) __syncthreads();  // s_half is free for the next group
      }
    }
    clock.end(4);
    cluster.sync();
    clock.end(5);

    // 4. the halo, the NLM, the new x: f32 carried, bf16 operand
    column_halo_nlm<kNT>(cluster, s_g, s_nih, K, seg, k0, nk, nrows, [&](int r, int j, float v) {
      s_xown[r * seg + j] = v;
      s_x[r * ldw + j] = __float2bfloat16_rn(v);
    });
    clock.end(6);
  }
  cluster.sync();  // no peer reads this CTA's shared memory after this
  for (int e = tid; e < nrows * nk; e += kNT) {
    const int r = e / nk, j = e - r * nk;
    a.out[(size_t)(row0 + r) * K + k0 + j] = s_xown[r * seg + j];
  }
}

// The panel tier: pnp_ista_panel<false> (f32) and <true> (bf16).
#include "ista_panel.cuh"

// The kernels' slots below: 0 f32, 1 bf16 (slices of D resident); streamed:
// 3 bf16, f32 in stages of 8 or 16 rows with tiles of 16 block rows (2, 6)
// or 12 (7, 8); column: 4, 9 f32 with tiles of 12, 4 rows, 5 bf16; panel:
// 10 f32, 11 bf16.
constexpr int kKernels = 12;

// The attributes already set on each kernel, so that they are set by the
// first launch of a shape and a launch recorded into a CUDA graph after it
// calls no cudaFuncSetAttribute.
struct KernelAttributes {
  int smem = 0;
  bool non_portable = false;
};
KernelAttributes g_attributes[kKernels];

template <typename Kernel>
cudaError_t configure(Kernel kernel, int index, int cluster_size, int nclusters, int smem,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int threads = kThreads) {
  KernelAttributes& set = g_attributes[index];
  cudaError_t err;
  if (smem > set.smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set.smem = smem;
  }
  if (cluster_size > 8 && !set.non_portable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    set.non_portable = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster_size * nclusters);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster_size;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <bool kBf16, int kS, int kRT>
cudaError_t launch_stream(int slot, const StreamArgs& sa, int cluster_size, int nclusters, int smem,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(pnp_ista_stream<kBf16, kS, kRT>, slot, cluster_size, nclusters, smem, stream,
                              &cfg, &attr, stream_threads<kBf16>());
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, pnp_ista_stream<kBf16, kS, kRT>, sa);
  return err;
}

template <typename Kernel>
cudaError_t launch_column(Kernel kernel, int slot, const ColumnArgs& ca, int cluster_size, int nclusters, int smem,
                          int threads, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, slot, cluster_size, nclusters, smem, stream, &cfg, &attr, threads);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, ca);
  return err;
}

// Row strides of the column kernels' copies of D, in elements: f32 rows
// padded to 8 floats; bf16 rows padded to 16 values, and the transpose's
// rows (columns of D, padded to 16) of P padded to 16 values.
inline int column_rows_ld(int bf16, int K) { return bf16 ? round_up(K, 16) : round_up(K, 8); }

long long column_scratch_floats(int bf16, int P, int K, int Pr) {
  if (!column_copies_d(bf16, K, P, Pr)) return 0;
  const long long kp = column_rows_ld(bf16, K);
  return bf16 ? (P * kp + kp * round_up(P, 16)) / 2 : P * kp;
}

// Floats of device memory that a panel launch's stage images take.
long long panel_scratch_floats(int cluster_size, int stages) {
  return (long long)cluster_size * stages * kPanelStageBytes / 4;
}

template <bool kBf16>
cudaError_t launch_panel(int slot, const PanelArgs& pa, int cluster_size, int nclusters, int smem,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure(pnp_ista_panel<kBf16>, slot, cluster_size, nclusters, smem, stream, &cfg, &attr, kPanelThreads);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, pnp_ista_panel<kBf16>, pa);
  return err;
}

}  // namespace

extern "C" {

// Dynamic shared memory per CTA, in bytes, for a plan.
int lrs_pnp_ista_smem_bytes(int bf16, int R, int Pc, int K, int seg) {
  return make_layout(bf16, R, Pc, K, seg).total;
}

// The same for the streamed kernels, with Pr resident rows and a ring of
// `stages` stages.
int lrs_pnp_ista_stream_smem_bytes(int bf16, int R, int K, int seg, int Pr, int stages, int S) {
  return make_stream_layout(bf16, R, K, seg, Pr, stages, S).total;
}

// Row stride, in bf16 values, of the rounded copy of D the bf16 streamed
// kernel reads its streamed rows from (the wrapper allocates P times it).
int lrs_pnp_ista_stream_copy_stride(int bf16, int K) {
  return stream_copies_d(bf16, K) ? make_stream_layout(bf16, 1, K, 4, 0, 0, bf16 ? kStageBf16 : 8).kp : 0;
}

// The same for the column kernels, with R rows per cluster, seg columns
// and Pr resident rows of D[:, k_c] per CTA.
int lrs_pnp_ista_column_smem_bytes(int bf16, int R, int P, int seg, int Pr) {
  return make_column_layout(bf16, R, column_tile_rows(bf16, R), P, seg, Pr).total;
}

// Floats of device-memory scratch a launch of the column kernels takes for
// its copies of D (0: it reads D itself).
long long lrs_pnp_ista_column_scratch_floats(int bf16, int P, int K, int Pr) {
  return column_scratch_floats(bf16, P, K, Pr);
}

int lrs_pnp_ista_max_clusters(int bf16, int cluster_size, int smem) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t err =
      bf16 ? configure(pnp_ista_cluster_bf16, 1, cluster_size, 1, smem, nullptr, &cfg, &attr)
           : configure(pnp_ista_cluster_f32, 0, cluster_size, 1, smem, nullptr, &cfg, &attr);
  if (err == cudaSuccess) {
    err = bf16 ? cudaOccupancyMaxActiveClusters(&n, pnp_ista_cluster_bf16, &cfg)
               : cudaOccupancyMaxActiveClusters(&n, pnp_ista_cluster_f32, &cfg);
  }
  return err == cudaSuccess ? n : -(int)err;
}

static int finish_launch(cudaError_t err) {
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky launch error; the caller raises
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// Launches the fused loop on `stream` as nclusters clusters of cluster_size
// CTAs; returns the cudaError_t (0 on success).  R rows per cluster, Pc rows
// of D and seg columns of x per CTA, as the plan in ops/ista_cuda.py chose.
int lrs_pnp_ista_launch(const float* y, const float* m, const float* d,
                        const float* alpha, float h_coef, float* out, int nB, int P,
                        int K, int n_iter, int bf16, int cluster_size, int nclusters, int R,
                        int Pc, int seg, void* stream) {
  const Args a = {y, m, d, alpha, h_coef, out, nB, P, K, n_iter, R, Pc, seg};
  const int smem = make_layout(bf16, R, Pc, K, seg).total;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = configure(pnp_ista_cluster_bf16, 1, cluster_size, nclusters, smem, s, &cfg, &attr);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, pnp_ista_cluster_bf16, a);
  } else {
    err = configure(pnp_ista_cluster_f32, 0, cluster_size, nclusters, smem, s, &cfg, &attr);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, pnp_ista_cluster_f32, a);
  }
  return finish_launch(err);
}

// The streamed kernels: the same arguments, Pr resident rows of each slice,
// a ring of `stages` stages of S rows (f32: 8 or 16; bf16: 16) and, where
// stream_copies_d and there are stages, `copy`: P times
// lrs_pnp_ista_stream_copy_stride(bf16, K) values (bf16 or f32) of device
// memory into which the launch first copies D (a second kernel on the same
// stream).
int lrs_pnp_ista_stream_launch(const float* y, const float* m, const float* d,
                               const float* alpha, float h_coef, float* out, void* copy,
                               int nB, int P, int K, int n_iter, int bf16, int cluster_size,
                               int nclusters, int R, int Pc, int seg, int Pr, int stages, int S,
                               void* stream) {
  const int copies = stages > 0 && stream_copies_d(bf16, K);
  const int kp = lrs_pnp_ista_stream_copy_stride(bf16, K);
  const StreamArgs sa = {{y, m, d, alpha, h_coef, out, nB, P, K, n_iter, R, Pc, seg},
                         copies ? copy : static_cast<const void*>(d), copies ? kp : K, Pr, stages};
  if (bf16 ? S != kStageBf16 : (S != 8 && (S != 16 || round_up(K, 8) > 512))) return (int)cudaErrorInvalidValue;
  if (R > kRowsSt) return (int)cudaErrorInvalidValue;
  const StreamLayout L = make_stream_layout(bf16, R, K, seg, Pr, stages, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (copies) {
    if (copy == nullptr) return (int)cudaErrorInvalidValue;
    const long long n = (long long)P * kp;
    const int blocks = (int)((n + kThreads - 1) / kThreads < 1024 ? (n + kThreads - 1) / kThreads : 1024);
    if (bf16)
      copy_d_rows<<<blocks, kThreads, 0, s>>>(d, static_cast<__nv_bfloat16*>(copy), P, K, kp);
    else
      copy_d_rows<<<blocks, kThreads, 0, s>>>(d, static_cast<float*>(copy), P, K, kp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (bf16) {
    err = launch_stream<true, kStageBf16, kRowsSt>(3, sa, cluster_size, nclusters, L.total, s);
  } else if (R <= 12) {  // f32 tiles of 12 rows
    err = S == 8 ? launch_stream<false, 8, 12>(7, sa, cluster_size, nclusters, L.total, s)
                 : launch_stream<false, 16, 12>(8, sa, cluster_size, nclusters, L.total, s);
  } else {
    err = S == 8 ? launch_stream<false, 8, 16>(2, sa, cluster_size, nclusters, L.total, s)
                 : launch_stream<false, 16, 16>(6, sa, cluster_size, nclusters, L.total, s);
  }
  return finish_launch(err);
}

// The column kernels: the same arguments, seg columns of x and D per CTA,
// Pr rows of D[:, k_c] resident per CTA and, where column_copies_d, `copy`:
// lrs_pnp_ista_column_scratch_floats of device memory into which the launch
// first copies D (one or two kernels before the loop on the same stream).
int lrs_pnp_ista_column_launch(const float* y, const float* m, const float* d,
                               const float* alpha, float h_coef, float* out, void* copy,
                               int nB, int P, int K, int n_iter, int bf16, int cluster_size,
                               int nclusters, int R, int Pc, int seg, int Pr, void* stream) {
  const bool copies = column_copies_d(bf16, K, P, Pr);
  if (copies && copy == nullptr) return (int)cudaErrorInvalidValue;
  if (R > (bf16 ? kRowsBf16 : 12) || seg % (bf16 ? 16 : 8) != 0 || Pc % 4 != 0 || Pr > P ||
      (bf16 && Pr < P && Pr % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int ld = column_rows_ld(bf16, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ColumnArgs ca = {{y, m, d, alpha, h_coef, out, nB, P, K, n_iter, R, Pc, seg}, d, K, nullptr, Pr};
  if (copies) {
    const long long n = (long long)P * ld;
    const int blocks = (int)((n + kThreads - 1) / kThreads < 1024 ? (n + kThreads - 1) / kThreads : 1024);
    ca.rows_ld = ld;
    if (bf16) {
      __nv_bfloat16* rows = static_cast<__nv_bfloat16*>(copy);
      __nv_bfloat16* cols = rows + (size_t)P * ld;
      copy_d_rows<<<blocks, kThreads, 0, s>>>(d, rows, P, K, ld);
      copy_dt_rows<<<blocks, kThreads, 0, s>>>(d, cols, P, K, ld, round_up(P, 16));
      ca.rows = rows;
      ca.cols = cols;
    } else {
      copy_d_rows<<<blocks, kThreads, 0, s>>>(d, static_cast<float*>(copy), P, K, ld);
      ca.rows = copy;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int RT = column_tile_rows(bf16, R);
  const int smem = make_column_layout(bf16, R, RT, P, seg, Pr).total;
  cudaError_t err;
  if (bf16)
    err = launch_column(pnp_ista_column_bf16, 5, ca, cluster_size, nclusters, smem, kThreads, s);
  else if (RT == 12)
    err = launch_column(pnp_ista_column_f32<12>, 4, ca, cluster_size, nclusters, smem, kColThreadsF32, s);
  else
    err = launch_column(pnp_ista_column_f32<4>, 9, ca, cluster_size, nclusters, smem, kColThreadsF32, s);
  return finish_launch(err);
}

// The panel kernels: the same arguments, R <= 64 rows per cluster, seg
// columns of x per CTA (a multiple of 4, in bf16 of 16), `stages` stages of
// each CTA's Pc rows of D (Pc / 16 rounded up in f32, Pc / 32 in bf16) and
// `copy`: lrs_pnp_ista_panel_scratch_floats of device memory into which the
// launch first lays out the stages' images (a second kernel before the loop
// on the same stream).  K <= 512.
int lrs_pnp_ista_panel_launch(const float* y, const float* m, const float* d,
                              const float* alpha, float h_coef, float* out, void* copy,
                              int nB, int P, int K, int n_iter, int bf16, int cluster_size,
                              int nclusters, int R, int Pc, int seg, int stages, void* stream) {
  const int S = panel_stage_rows(bf16);
  if (copy == nullptr || R > kPanelRows || R < 1 || round_up(K, 16) > kPanelK || seg % (bf16 ? 16 : 4) != 0 ||
      cluster_size * seg < K || cluster_size * seg > kPanelK || stages != (Pc + S - 1) / S ||
      (cluster_size & (cluster_size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = panel_scratch_floats(cluster_size, stages) * (bf16 ? 2 : 1);
  const int blocks = (int)((n + kThreads - 1) / kThreads < 1024 ? (n + kThreads - 1) / kThreads : 1024);
  if (bf16)
    panel_images<<<blocks, kThreads, 0, s>>>(d, static_cast<__nv_bfloat16*>(copy), P, K, Pc, stages, cluster_size);
  else
    panel_images<<<blocks, kThreads, 0, s>>>(d, static_cast<float*>(copy), P, K, Pc, stages, cluster_size);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const PanelArgs pa = {{y, m, d, alpha, h_coef, out, nB, P, K, n_iter, R, Pc, seg}, copy, stages};
  const int smem = make_panel_layout(bf16, seg).total;
  err = bf16 ? launch_panel<true>(11, pa, cluster_size, nclusters, smem, s)
             : launch_panel<false>(10, pa, cluster_size, nclusters, smem, s);
  return finish_launch(err);
}

// Dynamic shared memory of a panel CTA with seg columns of x.
int lrs_pnp_ista_panel_smem_bytes(int bf16, int seg) { return make_panel_layout(bf16, seg).total; }

// Floats of device-memory scratch of a panel launch (its stage images).
long long lrs_pnp_ista_panel_scratch_floats(int cluster_size, int stages) {
  return panel_scratch_floats(cluster_size, stages);
}

// Clusters of cluster_size panel CTAs that the card keeps resident at the
// panel's shared memory (seg columns of x), or minus the cudaError_t.
int lrs_pnp_ista_panel_max_clusters(int bf16, int cluster_size, int seg) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = 0;
  const int smem = make_panel_layout(bf16, seg).total;
  cudaError_t err = bf16 ? configure(pnp_ista_panel<true>, 11, cluster_size, 1, smem, nullptr, &cfg, &attr,
                                     kPanelThreads)
                         : configure(pnp_ista_panel<false>, 10, cluster_size, 1, smem, nullptr, &cfg, &attr,
                                     kPanelThreads);
  if (err == cudaSuccess) {
    err = bf16 ? cudaOccupancyMaxActiveClusters(&n, pnp_ista_panel<true>, &cfg)
               : cudaOccupancyMaxActiveClusters(&n, pnp_ista_panel<false>, &cfg);
  }
  return err == cudaSuccess ? n : -(int)err;
}

#ifdef ISTA_PROFILE
// Copies the phase cycle counters to `cycles` (8 values) and zeroes them.
int lrs_pnp_ista_phase_cycles(long long* cycles) {
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
