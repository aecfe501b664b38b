// Kernel B1's panel tier (pnp_ista_panel_f32 / pnp_ista_panel_bf16), for
// launches with many block rows.  Included by ista.cu inside its anonymous
// namespace: it uses that file's Args, PhaseClock, bulk copies, mbarriers,
// nlm_point and configure().
//
// Replaces, with the other tiers, the TPU kernel lrs_pnp_dip_tpu/ops/
// ista_pallas.py:pnp_ista_blocks_pallas (pallas_call at :179).  It computes
// what the other tiers compute (the note at the head of ista.cu): from x = 0,
// pred = x D^T, g = x + ((M Y - M pred) D) / alpha, x = NLM1d(g) along K,
// the NLM and the carried x in f32, bf16 rounding only the product operands.
//
// Why a fourth tier.  The resident, streamed and column tiers give a cluster
// at most 16 block rows, so a launch of nB 2304 runs 16 to 30 waves, and each
// wave pays in every iteration the same fixed costs: step 3 (the
// reduce-scatter of the partial gradient through distributed shared memory,
// the NLM, the all-gather of x) and its cluster syncs, which nothing
// overlaps.  The panel tier gives a cluster a panel of 64 block rows (the
// wgmma's m) for the whole loop: nB 2304 is 45 clusters of 52 rows, 3 waves
// of clusters of 8, where the resident tier runs 210 clusters of 11 in 30.
//
// Bound.  The same 4 nB P K n_iter operations: at nB 2304, P 1296, K 512,
// 100 iterations 6.1e11 flops, 9.13 ms in f32 on the CUDA cores (67 TFLOP/s
// on an H100 SXM), 0.618 ms with bf16 operands on the tensor cores (989
// TFLOP/s).  It is bound by operations: D and the blocks are 14 MB.
//
// Design.  A cluster of C CTAs (8 or 16) owns a panel of R <= 64 rows; CTA c
// owns the slice D[p_c, :] (Pc = P / C rows) and the columns k_c of x in step
// 3, as in the resident tier.  The split is by P and not by K: splitting K
// would exchange a 64 x P partial prediction per CTA and iteration, larger
// than the 64 x K partial gradient at every shape the tier takes (K <= 512,
// P >= 576 where it is picked).  The slice does not fit beside a 64-row x
// (f32: 162 rows of 512 floats are 331 KB at C 8; bf16: 166 KB beside x's 64
// KB), so it is streamed, once per iteration, as stages of S rows (f32 16,
// bf16 32) through a ring (f32 2 slots, bf16 3): thread 0 copies a stage into
// its slot with bulk copies completing on the slot's mbarrier, from images of
// the stages that the launch lays out in device memory first (panel_images:
// in the order shared memory wants them, so each stage is one contiguous run
// of 32 KB, and in bf16 rounded once).  No stage is shared by two CTAs of a
// cluster, so there is nothing to multicast.  The CTA's 256 threads walk the
// stages (no producer warp: a ninth warp would put three warps on one of the
// SM's four schedulers and cap every thread at 168 registers, where product
// 2's accumulators alone take 128); for stage s:
//
//   1. pred_s = x D_s^T (64 x S) and the residual r_s = Ym - M pred_s
//      (bf16: rounded), into shared memory;                -- __syncthreads --
//      every thread has read stage s - 1: thread 0 copies stage s - 1 + ring
//      into its slot, which then has at least product 2 of stage s to arrive;
//   2. G += r_s D_s, the partial gradient (64 x K) held in registers for the
//      whole pass.
//
// After the pass G goes to shared memory in x's place (x is not read again
// in the iteration; -- cluster.sync --) and step 3 follows: (a) CTA c sums
// the C partials of its columns and their halo of 4 in the fixed ring order
// from its successor and adds the carried x; -- cluster.sync -- (b) the NLM
// on its columns into its carried x, in place (every peer has read it), and
// the new x of its columns (all 64 rows, zeros past K and past the panel's
// rows) into its own operand copy, where they are one contiguous block, which
// thread 0 bulk-copies into every peer's copy.  A CTA waits for its peers'
// blocks on an mbarrier (the bytes it expects) before its next pass, and a
// split cluster barrier (arrive after that wait, wait before G is written)
// keeps G off a block that a peer is still copying.  Rows past nB have Ym = M
// = 0: their residual is 0 and their x stays 0.
//
// f32 (pnp_ista_panel_f32): exact f32 on the CUDA cores, register tiles of
// the SGEMM kind.  Product 1: warp w takes rows 8w .. 8w + 7, its lanes four
// groups of 4 stage rows by eight shares of K (float4 columns q with q % 8 the
// share), 8 x 4 accumulators a lane; the shares' sums are added by a butterfly
// (xor 1, 2, 4), so every lane holds the same sums.  x is kept as [K/4][65
// rows][4] so that a warp's loads of 8 shares fall into distinct banks.
// Product 2: warp w takes rows 8w .. 8w + 7, lane l the float4 columns l,
// l + 32, l + 64, l + 96 of G: 128 accumulators a thread, 6 loads of 16 bytes
// per 128 FMAs.
//
// bf16 (pnp_ista_panel_bf16): both products on wgmma.mma_async (m64nNk16,
// bf16 in, f32 accumulators), A and B from shared memory through matrix
// descriptors without swizzle: every operand is kept as 8 x 8 core matrices
// of 128 bytes (rows of 16 bytes), and one image of a stage of D, core
// matrix (8 rows p, 8 columns k), serves as B in both products: K-major in
// product 1 (N = p) and, with the transpose bit, MN-major in product 2 (N =
// k).  Two warpgroups: in product 1 warpgroup g takes half of K's k steps
// for all S stage rows (m64n32k16, one chain of at most 16 steps), and the
// two halves of pred are added in f32 through shared memory before the
// residual; in product 2 it takes the columns 256g .. 256g + 255 of G (two
// m64n256k16 per stage, 128 accumulators a thread), whose chain over the
// slice's P / 16 steps (11 at P 1296 and C 8, 22 at P 2704) is not cut either.
// Both are shorter than the resident tier's uncut chain of 40 k steps at K
// 640, which sits under both bf16 floors of the card tests.
//
// Every sum runs in a fixed order without atomics, so two launches give
// equal bits.  Nothing goes through device memory per iteration but the
// stages of D (L2: C Pc K values per cluster).
//
// What bounds it now (scripts/profile_b1_phases.py --shapes panel, nB 2304,
// clusters of 8, NVIDIA H100 80GB HBM3, 700.00 W): in f32 product 1 takes
// about half of an iteration and runs at some 45% of the FMA rate; its
// 16-byte shared loads, 12 per 128 FMAs (twice product 2's), are the likely
// limit, not measured apart; product 2 runs near the FMA rate and takes a
// quarter; step 3 and the waits the rest.  In bf16 the products take about a
// third of an iteration and step 3 (the pull, the NLM of 52 rows, the
// cluster syncs and the wait for the peers' x) the rest: the fixed cost per
// wave is smaller than the other tiers' per row, not gone.

constexpr int kPanelRows = 64;                        // rows of a panel: the wgmma's m (R <= 64)
constexpr int kPanelK = 512;                          // the columns the panel takes (K <= 512)
constexpr int kPanelThreads = 256;                    // two warpgroups / eight warps
constexpr int kPanelLdg = kPanelK + 8;                // row stride of G in shared memory, floats
constexpr int kPanelStageBytes = 32768;               // one stage of D: 16 x 512 f32 or 32 x 512 bf16
constexpr int kPanelCopy = 4096;                      // bytes per bulk copy (8 per stage)
constexpr int kPredLd = 40;                           // bf16: row stride of the halves of pred, floats

__host__ __device__ constexpr int panel_stage_rows(bool bf16) { return bf16 ? 32 : 16; }
__host__ __device__ constexpr int panel_ring(bool bf16) { return bf16 ? 3 : 2; }

// Byte offsets in dynamic shared memory.  ops/ista_cuda.py:panel_smem_bytes
// computes the same total.
struct PanelLayout {
  int x;     // operand x: f32 [K/4][65][4], bf16 core matrices [K/8][8][8 x 8]
  int g;     // G [64][kPanelLdg] f32 after the pass, in x's place (bf16: and the ring's)
  int ring;  // the ring of stages
  int gseg;  // step 3's gradient segment [64][seg + 8] (f32: in the ring's place)
  int res;   // the residual of a stage, two buffers: f32 [S][64], bf16 core matrices
  int pred;  // bf16: the two warpgroups' halves of pred, [2][64][kPredLd] f32
  int xown;  // the carried x of the CTA's columns [64][seg]
  int vec;   // 1/alpha and -1/(9 h^2) of the panel's rows
  int bar;   // an mbarrier per ring slot (its stage arrived), then the x mbarrier (the peers' columns arrived)
  int total;
};

__host__ __device__ inline PanelLayout make_panel_layout(int bf16, int seg) {
  PanelLayout L;
  const int S = panel_stage_rows(bf16), ring = panel_ring(bf16);
  const int bytes_x = bf16 ? kPanelRows * kPanelK * 2 : (kPanelK / 4) * (kPanelRows + 1) * 16;
  const int bytes_gseg = kPanelRows * (seg + 2 * kHalo) * 4;
  L.x = 0;
  L.g = 0;
  L.ring = bytes_x;
  int end = L.ring + ring * kPanelStageBytes;
  if (bf16) {
    L.gseg = end;
    end += round_up(bytes_gseg, 16);
  } else {
    L.gseg = L.ring;
  }
  L.res = end;
  end += 2 * S * kPanelRows * (bf16 ? 2 : 4);
  L.pred = end;
  end += bf16 ? 2 * kPanelRows * kPredLd * 4 : 0;
  L.xown = end;
  end += round_up(kPanelRows * seg * 4, 16);
  L.vec = end;
  end += 2 * kPanelRows * 4;
  L.bar = end;
  L.total = end + (ring + 1) * 8;
  return L;
}

struct PanelArgs {
  Args a;              // R <= 64 rows per cluster, Pc rows of D and seg columns of x per CTA
  const void* images;  // the stages of D as shared memory wants them: [C][stages][kPanelStageBytes]
  int stages;          // stages per slice: Pc / S rounded up
};

// The element of D at byte offset o of stage image (c, s): f32 rows of 512
// floats; bf16 core matrices (8 rows p by 8 columns k, 128 bytes), the four
// of 8 rows of a stage column block after column block.
template <typename T>
__global__ void __launch_bounds__(kThreads) panel_images(const float* d, T* out, int P, int K, int Pc, int stages,
                                                         int C) {
  constexpr bool bf16 = !std::is_same<T, float>::value;
  constexpr int S = panel_stage_rows(bf16), per_stage = S * kPanelK;
  const size_t n = (size_t)C * stages * per_stage;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += (size_t)gridDim.x * kThreads) {
    const int cs = (int)(i / per_stage), o = (int)(i - (size_t)cs * per_stage);
    const int c = cs / stages, s = cs - c * stages;
    int p, k;
    if (bf16) {
      const int core = o >> 6, within = o & 63;
      p = (core % (S / 8)) * 8 + (within >> 3);
      k = (core / (S / 8)) * 8 + (within & 7);
    } else {
      p = o / kPanelK;
      k = o - p * kPanelK;
    }
    p += s * S;
    const int row = c * Pc + p;
    const float v = p < Pc && row < P && k < K ? d[(size_t)row * K + k] : 0.f;
    if constexpr (bf16)
      out[i] = __float2bfloat16_rn(v);
    else
      out[i] = v;
  }
}

// ---- wgmma (sm_90a) ----

// A shared-memory matrix descriptor without swizzle: the start address, the
// byte offset between core matrices along K (leading) and along M or N
// (stride), each in units of 16 bytes.  The card reads both fields so for the
// K-major and the MN-major operand alike: with the two swapped, product 1 gave
// NaN and product 2 errors of the order of the output (H100 80GB HBM3).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lead, uint32_t stride) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lead & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((stride & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving other accesses of the accumulators across
// the asynchronous wgmma that owns them (between issue and wait).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Orders this thread's generic writes to shared memory before the async
// proxy's reads of it (wgmma operands, bulk copies), in this CTA and in the
// peers it wrote to.
__device__ __forceinline__ void fence_proxy_async_all() { asm volatile("fence.proxy.async;\n" ::: "memory"); }

// d (64 x 32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 32), both K-major.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}

// d (64 x 256) += A (64 x 16, K-major) B (16 x 256, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_m64n256k16_bt(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// Bytes of one CTA's seg columns of the operand x, a contiguous block of its
// layout: f32 seg / 4 groups of 65 rows of 16 bytes; bf16 seg / 8 columns of
// 8 core matrices of 128 bytes.
__host__ __device__ inline int panel_x_block_bytes(int bf16, int seg) {
  return bf16 ? seg / 8 * 8 * 128 : seg / 4 * (kPanelRows + 1) * 16;
}

// The two halves of a cluster barrier: arrive early, wait late.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

// The shared::cluster address of `p`'s place in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_to_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// A bulk copy from this CTA's shared memory into a peer's, completing on the
// peer's mbarrier (both given as shared::cluster addresses).
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Step 3 of a panel's iteration, after the cluster sync that follows the
// pass: every CTA's G is complete in s_g (all threads of the CTA take part).
// With `push`, the new x goes to every CTA's operand copy; the receivers wait
// on their x mbarrier before the next pass.
template <bool kBf16, typename AfterPull>
__device__ __forceinline__ void panel_step3(cg::cluster_group& cluster, const Args& a, const PanelLayout& L,
                                            unsigned char* smem, int nrows, bool push, PhaseClock& clock,
                                            AfterPull after_pull) {
  const int C = cluster.num_blocks(), tid = threadIdx.x, rank = cluster.block_rank();
  const int K = a.K, seg = a.seg;
  const int k0 = min(K, rank * seg), k1 = min(K, k0 + seg);
  const int lo = max(0, k0 - kHalo), hi = min(K, k1 + kHalo);
  const int ldgs = seg + 2 * kHalo;
  float* s_g = reinterpret_cast<float*>(smem + L.g);
  float* s_gseg = reinterpret_cast<float*>(smem + L.gseg);
  float* s_xown = reinterpret_cast<float*>(smem + L.xown);
  const float* s_ia = reinterpret_cast<const float*>(smem + L.vec);
  const float* s_nih = s_ia + kPanelRows;
  // (a) the C partials of the CTA's columns and halo in ring order from its
  // successor, plus the carried x (the owners'), as 16-byte groups
  const int nquad = k1 > k0 ? (hi - lo + 3) / 4 : 0;
#pragma unroll 2
  for (int e = tid; e < nrows * nquad; e += kPanelThreads) {
    const int r = e / nquad, col = lo + 4 * (e - r * nquad);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int i = 0; i < C; ++i) {
      const int c = (rank + 1 + i) & (C - 1);
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(s_g, c) + r * kPanelLdg + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int owner = col / seg;
    const float4 xo =
        *reinterpret_cast<const float4*>(cluster.map_shared_rank(s_xown, owner) + r * seg + (col - owner * seg));
    const float ia = s_ia[r];
    *reinterpret_cast<float4*>(s_gseg + r * ldgs + (col - k0 + kHalo)) =
        make_float4(xo.x + s.x * ia, xo.y + s.y * ia, xo.z + s.z * ia, xo.w + s.w * ia);
  }
  clock.end(4);
  cluster.sync();  // every peer's G and carried x read
  after_pull();
  clock.end(7);
  // (b) the NLM on the CTA's columns into its carried x, in place, four
  // points a thread at a time, all computed before any is stored
  const int nseg = k1 - k0, npts = nrows * nseg;
  for (int e0 = tid; e0 < npts; e0 += 4 * kPanelThreads) {
    float v[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kPanelThreads < npts ? e0 + u * kPanelThreads : e0;
      const int r = e / nseg, j = e - r * nseg;
      at[u] = r * seg + j;
      v[u] = nlm_point(s_gseg + r * ldgs + kHalo - k0, k0 + j, K, s_nih[r]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) s_xown[at[u]] = v[u];
  }
  __syncthreads();
  clock.end(5);
  if (!push) return;
  // the new x of all 64 rows and the CTA's seg columns (zeros past K and
  // past the panel's rows: G's bytes lie in the operand's place) into its own
  // operand copy, 16 bytes at a time (4 columns in f32, 8 in bf16: a row of a
  // core matrix); the columns are one contiguous block of the operand's
  // layout, which thread 0 then copies into every peer's operand copy with a
  // bulk copy completing on the peer's x mbarrier
  constexpr int kCols = kBf16 ? 8 : 4;
  const int nsq = seg / kCols;
  unsigned char* xs = smem + L.x;
  for (int e = tid; e < kPanelRows * nsq; e += kPanelThreads) {
    const int r = e / nsq, j = kCols * (e - r * nsq);
    const int k = rank * seg + j;
    const bool live = r < nrows && k < K;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 v = live ? *reinterpret_cast<const float4*>(s_xown + r * seg + j) : zero;
    if constexpr (kBf16) {
      const float4 w = live ? *reinterpret_cast<const float4*>(s_xown + r * seg + j + 4) : zero;
      const __nv_bfloat162 q0 = __floats2bfloat162_rn(v.x, v.y), q1 = __floats2bfloat162_rn(v.z, v.w);
      const __nv_bfloat162 q2 = __floats2bfloat162_rn(w.x, w.y), q3 = __floats2bfloat162_rn(w.z, w.w);
      uint4 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&q0);
      packed.y = *reinterpret_cast<const uint32_t*>(&q1);
      packed.z = *reinterpret_cast<const uint32_t*>(&q2);
      packed.w = *reinterpret_cast<const uint32_t*>(&q3);
      *reinterpret_cast<uint4*>(xs + ((k >> 3) * 8 + (r >> 3)) * 128 + (r & 7) * 16) = packed;
    } else {
      reinterpret_cast<float4*>(xs)[(k >> 2) * (kPanelRows + 1) + r] = v;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the block, for the bulk copies
  __syncthreads();
  if (tid == 0) {
    const int block = panel_x_block_bytes(kBf16, seg);
    const unsigned char* src = xs + rank * block;
    uint64_t* s_xbar = reinterpret_cast<uint64_t*>(smem + L.bar) + panel_ring(kBf16);
    mbar_expect_tx(s_xbar, (C - 1) * block);  // the peers' blocks this CTA receives
    for (int i = 1; i < C; ++i) {
      const int c = (rank + i) & (C - 1);
      bulk_copy_to_peer(map_to_rank(src, c), src, block, map_to_rank(s_xbar, c));
    }
  }
  clock.end(6);
}

template <bool kBf16>
__global__ void __launch_bounds__(kPanelThreads, 1) pnp_ista_panel(const PanelArgs pa) {
  constexpr int S = panel_stage_rows(kBf16), NS = panel_ring(kBf16);
  cg::cluster_group cluster = cg::this_cluster();
  const Args& a = pa.a;
  extern __shared__ __align__(128) unsigned char psmem[];
  unsigned char* smem = psmem;
  const PanelLayout L = make_panel_layout(kBf16, a.seg);
  unsigned char* s_ring = smem + L.ring;
  float* s_g = reinterpret_cast<float*>(smem + L.g);
  float* s_xown = reinterpret_cast<float*>(smem + L.xown);
  float* s_ia = reinterpret_cast<float*>(smem + L.vec);
  float* s_nih = s_ia + kPanelRows;
  uint64_t* s_full = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = cluster.num_blocks(), rank = cluster.block_rank();
  const int row0 = blockIdx.x / C * a.R;
  const int nrows = min(a.R, a.nB - row0);
  const int P = a.P, K = a.K, ns = pa.stages;
  const int p0 = min(P, rank * a.Pc);
  const int pc = min(P, p0 + a.Pc) - p0;  // this CTA's rows of D
  const unsigned char* images = static_cast<const unsigned char*>(pa.images) + (size_t)rank * ns * kPanelStageBytes;

  // x = 0 (f32: the whole operand; bf16: it, and the ring), the carried x, the rows' scalars, the barriers
  zero16<kPanelThreads>(smem, L.ring + (kBf16 ? NS * kPanelStageBytes : 0));
  zero16<kPanelThreads>(s_xown, kPanelRows * a.seg * 4);
  if (tid < kPanelRows) {
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
  fence_proxy_async_all();
  uint64_t* s_xbar = s_full + NS;
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(s_full + i, 1);
    mbar_init(s_xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();

  uint32_t n_stage = 0;  // stages read so far, over all iterations: stage n lies in slot n % NS
  // Thread 0 copies stage s of the pass into its slot, the (n / NS)-th fill
  // of the slot, completing on its mbarrier.  The slot's earlier stage was
  // read by every thread before the barrier that precedes the call.
  auto fill = [&](int s) {
    const uint32_t slot = (n_stage + s) % NS;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(s_full + slot, kPanelStageBytes);
#pragma unroll
    for (int i = 0; i < kPanelStageBytes / kPanelCopy; ++i)
      bulk_copy(s_ring + slot * kPanelStageBytes + i * kPanelCopy,
                images + (size_t)s * kPanelStageBytes + i * kPanelCopy, kPanelCopy, s_full + slot);
  };
  PhaseClock clock;
  clock.begin();
  for (int it = 0; it < a.n_iter; ++it) {
    // the pass's first stages (bf16: after the first pass, filled during the step 3 before)
    if (tid == 0 && (!kBf16 || it == 0))
      for (int s = 0; s < min(NS, ns); ++s) fill(s);
    if (it > 0) mbar_wait(s_xbar, (it - 1) & 1u);  // the peers' columns of x
    // Every CTA past this point has received its peers' columns, so every
    // bulk copy out of this CTA's operand has landed: G may take its place
    // at the end of the pass (the wait below).
    cluster_arrive();
    if constexpr (!kBf16) {
      // ---- f32 consumers: 8 warps ----
      const int w = warp, pg = lane >> 3, sh = lane & 7;
      const int nq = (K + 3) / 4;                        // float4 columns of x and D with values
      const float4* xq = reinterpret_cast<const float4*>(smem + L.x);
      float4 gacc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) gacc[r][i] = make_float4(0.f, 0.f, 0.f, 0.f);
      // M and Y of this lane's 4 residual elements of stage s (0 past the panel's rows or the slice)
      auto load_m_y = [&](int s, float (&mn)[4], float (&yn)[4]) {
        const int r = 8 * w + sh;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = s * S + 4 * pg + b;
          const bool ok = s < ns && r < nrows && p < pc;
          const size_t at = (size_t)(row0 + r) * P + p0 + p;
          mn[b] = ok ? __ldg(a.m + at) : 0.f;
          yn[b] = ok ? __ldg(a.y + at) : 0.f;
        }
      };
      float m_next[4], y_next[4];
      load_m_y(0, m_next, y_next);
      for (int s = 0; s < ns; ++s) {
        const int slot = (n_stage + s) % NS;
        // Ym and M of the 4 residual elements this lane finishes (row 8w + sh,
        // stage rows 4pg .. 4pg + 3), loaded a stage ahead
        const int rr = 8 * w + sh;
        float ymv[4], mv[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          mv[b] = m_next[b];
          ymv[b] = m_next[b] * y_next[b];
        }
        load_m_y(s + 1, m_next, y_next);
        mbar_wait(s_full + slot, ((n_stage + s) / NS) & 1u);
        clock.end(3);
        const float4* dq = reinterpret_cast<const float4*>(s_ring + slot * kPanelStageBytes);  // [S][128]
        float* res = reinterpret_cast<float*>(smem + L.res) + (s & 1) * S * kPanelRows;      // [S][64]
        {
          // 1. pred for rows 8w .. 8w + 7 and stage rows 4pg .. 4pg + 3 over the share's columns
          float acc[8][4];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[r][b] = 0.f;
#pragma unroll 2
          for (int q = sh; q < nq; q += 8) {
            float4 dv[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) dv[b] = dq[(4 * pg + b) * (kPanelK / 4) + q];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float4 xv = xq[q * (kPanelRows + 1) + 8 * w + r];
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                acc[r][b] = fmaf(xv.x, dv[b].x, acc[r][b]);
                acc[r][b] = fmaf(xv.y, dv[b].y, acc[r][b]);
                acc[r][b] = fmaf(xv.z, dv[b].z, acc[r][b]);
                acc[r][b] = fmaf(xv.w, dv[b].w, acc[r][b]);
              }
            }
          }
          // the eight shares' sums, the same in every lane of the group
#pragma unroll
          for (int m = 1; m < 8; m <<= 1)
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int b = 0; b < 4; ++b) acc[r][b] += __shfl_xor_sync(0xffffffffu, acc[r][b], m);
          float pred[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (r == sh) {
#pragma unroll
              for (int b = 0; b < 4; ++b) pred[b] = acc[r][b];
            }
#pragma unroll
          for (int b = 0; b < 4; ++b) res[(4 * pg + b) * kPanelRows + rr] = ymv[b] - mv[b] * pred[b];
        }
        __syncthreads();  // the residual is complete; every thread has read stage s - 1
        if (tid == 0 && s >= 1 && s - 1 + NS < ns) fill(s - 1 + NS);
        clock.end(0);
        {
          // 2. G[8w + r][4 (lane + 32 i) ..] += r_s D_s over the stage's rows
          // in order, all 512 columns of the stage (zero past K): with no
          // branch on K the four loads of a row are issued ahead of their
          // FMAs (a branch per 128 columns put each load right before its
          // 32 FMAs, and products ran at half the FMA rate)
          const float4* res4 = reinterpret_cast<const float4*>(res);
#pragma unroll 4
          for (int p = 0; p < S; ++p) {
            const float4 ra = res4[p * (kPanelRows / 4) + 2 * w], rb = res4[p * (kPanelRows / 4) + 2 * w + 1];
            const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
            float4 dv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) dv[i] = dq[p * (kPanelK / 4) + lane + 32 * i];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int r = 0; r < 8; ++r) {
                float4& o = gacc[r][i];
                o.x = fmaf(rv[r], dv[i].x, o.x);
                o.y = fmaf(rv[r], dv[i].y, o.y);
                o.z = fmaf(rv[r], dv[i].z, o.z);
                o.w = fmaf(rv[r], dv[i].w, o.w);
              }
          }
        }
        clock.end(2);
      }
      // every thread has read x and the ring, every peer has received this
      // CTA's columns: G in x's place
      cluster_wait();
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) reinterpret_cast<float4*>(s_g + (8 * w + r) * kPanelLdg)[lane + 32 * i] = gacc[r][i];
    } else {
      // ---- bf16 consumers: two warpgroups ----
      const int wg = warp >> 2, w4 = warp & 3;
      const int nks = (K + 15) / 16;  // product 1's k steps
      const unsigned char* xs = smem + L.x;
      unsigned char* res_base = smem + L.res;
      float* s_pred = reinterpret_cast<float*>(smem + L.pred);
      float gacc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) gacc[i] = 0.f;
      // M and Y of stage s at the accumulator's places of this warpgroup's
      // stage rows: rows 16 w4 + lane / 4 (+ 8), stage rows 16 wg + 8 j + 2
      // (lane % 4) (+ 1); 0 past the panel's rows or the slice
      auto load_m_y = [&](int s, float (&mn)[8], float (&yn)[8]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = 16 * w4 + (lane >> 2) + 8 * ((e >> 1) & 1);
          const int p = s * S + 16 * wg + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
          const bool ok = s < ns && r < nrows && p < pc;
          const size_t at = (size_t)(row0 + r) * P + p0 + p;
          mn[e] = ok ? __ldg(a.m + at) : 0.f;
          yn[e] = ok ? __ldg(a.y + at) : 0.f;
        }
      };
      float m_next[8], y_next[8];
      load_m_y(0, m_next, y_next);
      for (int s = 0; s < ns; ++s) {
        const int slot = (n_stage + s) % NS;
        // Ym and M at the residual's places, loaded a stage ahead
        float ymv[8], mv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          mv[e] = m_next[e];
          ymv[e] = m_next[e] * y_next[e];
        }
        load_m_y(s + 1, m_next, y_next);
        mbar_wait(s_full + slot, ((n_stage + s) / NS) & 1u);
        clock.end(3);
        const unsigned char* stage = s_ring + slot * kPanelStageBytes;
        unsigned char* res = res_base + (s & 1) * S * kPanelRows * 2;
        {
          // 1. pred (64 x S) over this warpgroup's half of K's k steps, one
          // wgmma chain (at most 16 steps: K <= 512), into shared memory
          const int half = (nks + 1) / 2, ka = wg * half, kb = min(nks, ka + half);
          float part[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) part[e] = 0.f;
          fence_operands(part);
          wgmma_fence();
          for (int ks = ka; ks < kb; ++ks) {
            // A: x, core matrices [k / 8][r / 8]: 128 bytes along M, 1024 along K
            // B: the stage, core matrices [k / 8][p / 8]: 128 bytes along N (p), (S / 8) 128 along K
            wgmma_m64n32k16(part, wgmma_desc(xs + ks * 2048, 1024, 128),
                            wgmma_desc(stage + ks * 2 * (S / 8) * 128, (S / 8) * 128, 128), ks > ka);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_operands(part);
          float* pp = s_pred + wg * kPanelRows * kPredLd;
#pragma unroll
          for (int j = 0; j < S / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(pp + (16 * w4 + (lane >> 2) + 8 * h) * kPredLd + 8 * j + 2 * (lane & 3)) =
                  make_float2(part[4 * j + 2 * h], part[4 * j + 2 * h + 1]);
        }
        __syncthreads();  // both halves of pred are in shared memory
        {
          // the residual of stage rows 16 wg .. 16 wg + 15, the halves added
          // in order, rounded, into the A operand of product 2: core
          // matrices [p / 8][r / 8]
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const int r = 16 * w4 + (lane >> 2) + 8 * ((e >> 1) & 1);
            const int p = 16 * wg + 8 * (e >> 2) + 2 * (lane & 3);
            const float2 lo = *reinterpret_cast<const float2*>(s_pred + r * kPredLd + p);
            const float2 hi = *reinterpret_cast<const float2*>(s_pred + (kPanelRows + r) * kPredLd + p);
            const __nv_bfloat162 v = __floats2bfloat162_rn(ymv[e] - mv[e] * (lo.x + hi.x),
                                                           ymv[e + 1] - mv[e + 1] * (lo.y + hi.y));
            *reinterpret_cast<__nv_bfloat162*>(res + ((p >> 3) * 8 + (r >> 3)) * 128 + (r & 7) * 16 + (p & 7) * 2) = v;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();  // the residual is complete; every thread has read stage s - 1
        if (tid == 0 && s >= 1 && s - 1 + NS < ns) fill(s - 1 + NS);
        clock.end(0);
        // 2. G[:, 256 wg ..] += r_s D_s: two k steps of 16 stage rows
        fence_operands(gacc);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < S / 16; ++t) {
          // A: r_s, core matrices [p / 8][r / 8]: 128 bytes along M, 1024 along K (p)
          // B: the stage MN-major, core matrices [k / 8][p / 8]: (S / 8) 128 bytes along N (k), 128 along K (p)
          wgmma_m64n256k16_bt(gacc, wgmma_desc(res + t * 2048, 1024, 128),
                              wgmma_desc(stage + (32 * wg * (S / 8) + 2 * t) * 128, 128, (S / 8) * 128));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(gacc);
        clock.end(2);
      }
      // every thread has read x, the ring and the residual, every peer has
      // received this CTA's columns: G in their place
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cluster_wait();
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * w4 + (lane >> 2) + 8 * h;
          const int col = 256 * wg + 8 * j + 2 * (lane & 3);
          *reinterpret_cast<float2*>(s_g + r * kPanelLdg + col) = make_float2(gacc[4 * j + 2 * h], gacc[4 * j + 2 * h + 1]);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // bf16: the next pass's copies land on G
    clock.end(1);
    n_stage += ns;
    cluster.sync();  // every CTA's G is complete
    clock.end(7);
    // bf16: the ring lies in G's place, free once every peer has pulled its
    // partials; the next pass's first stages arrive during the NLM and the
    // push (f32: step 3's gradient segment lies in the ring's place)
    panel_step3<kBf16>(cluster, a, L, smem, nrows, it + 1 < a.n_iter, clock, [&]() {
      if (kBf16 && tid == 0 && it + 1 < a.n_iter)
        for (int s = 0; s < min(NS, ns); ++s) fill(s);
    });
    // f32: step 3's gradient segment, read by the NLM, lies in the ring's place
    fence_proxy_async_all();
    __syncthreads();
  }
  cluster.sync();  // no peer reads this CTA's shared memory after this
  // the carried x of the CTA's columns
  const int k0 = min(K, rank * a.seg), nseg = min(K, k0 + a.seg) - k0;
  for (int e = tid; e < nrows * nseg; e += kPanelThreads) {
    const int r = e / nseg, j = e - r * nseg;
    a.out[(size_t)(row0 + r) * K + k0 + j] = s_xown[r * a.seg + j];
  }
}
