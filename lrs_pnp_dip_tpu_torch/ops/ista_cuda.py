"""Kernel B1: the fused PnP-ISTA loop as a hand-written CUDA kernel for
Hopper (``csrc/ista.cu``), the port of the TPU kernel
``lrs_pnp_dip_tpu/ops/ista_pallas.py:pnp_ista_blocks_pallas``.

The kernel runs as thread block clusters: a cluster of C CTAs owns R block
rows for the whole loop, CTA c owns the slice ``D[p_c, :]`` and the columns
``k_c`` of x in step 3 (see the note in the source).  Three tiers take the
shapes of the TPU kernel's range: ``"resident"`` (each slice of D in shared
memory), ``"streamed"`` (the first rows of each slice resident, the rest
read once per iteration through a ring of stages) and ``"column"`` (the
long-K tail: CTA c owns the columns ``k_c`` of D and x for all P, the
products' partial pred summed through the cluster).  :func:`plan_ista`
chooses the tier, C, R, the slices and the shared-memory bytes from (nB, P,
K, operand type) in plain Python, so the tiling is testable without a card:
of the tiers that take the shape, the one with the least predicted time,
from constants fitted to the card's timings of every tier.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (into ``csrc/build/``, named by the
hash of the source and flags) and loaded with ``ctypes``.  Nothing is
compiled or loaded when this module is imported.

:func:`.ista.pnp_ista_blocks_fused` prepares the kernel's inputs and
calls :meth:`FusedIstaKernel.launch`, which takes CUDA tensors only.  A
launch the card refuses (cluster size, shared memory) raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Mapping, Optional

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
_MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


# Limits of the kernel's register tiles (csrc/ista.cu).
_F32_ROWS = 11  # kRowsF32: rows per cluster in f32 mode
_BF16_ROWS = 16  # kRowsBf16: the mma tile's rows
_F32_MAX_SLICE = 96  # 32 lanes x kColsP columns p
_BF16_MAX_SLICE = 192  # 8 warps x kTilesP tiles of 8
_BF16_MAX_K = 640  # 8 warps x kPairsK tiles of 16
_WARPS = 8
_HALO = 4  # the NLM's reach along K
# The streamed kernel (csrc/ista.cu, pnp_ista_stream): at most 16 rows of x
# per cluster in its tiles, stages of whole rows (8 or 16 in f32, 16 in bf16),
# a ring of at most 3 stages; the f32 partial gradient is one float4 column
# per thread (K <= 1024), the bf16 one 10 tiles of 16 columns per warp (K <=
# 1280).
_STREAM_ROWS = 16
# Stage heights the plan tries, in order: f32 takes 16 rows up to K 512 where
# a ring of them fits (at block 40 it ran 14% faster than 8 on an H100, beside
# fewer resident rows: scripts/profile_b1_phases.py --stage-rows), else 8.
_STAGE_ROWS = {False: (16, 8), True: (16,)}
# Stages of the ring (kRing): a slot is released before the step's other work
# and refilled while it runs.
_RING = 3
_STREAM_MAX_K = {False: 1024, True: 1280}
# The column kernels (pnp_ista_column_f32 / _bf16): at most 12 rows per
# cluster in f32 (register tiles of 4 or 12 rows, 512 threads), 16 in
# bf16 (the mma's m); columns per CTA a multiple of 8 (f32) or 16 (bf16).
_COL_ROWS = {False: 12, True: 16}
_COL_THREADS_F32 = 512
_COL_SEG_ALIGN = {False: 8, True: 16}
# The TPU kernel's VMEM budget and its smallest row tile
# (lrs_pnp_dip_tpu/ops/ista_pallas.py:151-158): the range of shapes B1 takes.
_TPU_VMEM_BUDGET = 12 * 2**20
_TPU_MIN_TILE = 8
# Clusters of 8 and of 16 CTAs that an H100 SXM keeps resident with one CTA
# per SM (cudaOccupancyMaxActiveClusters, scripts/probe_clusters.cu).  The
# wrapper asks the card it runs on; these serve a plan made without one.
H100_RESIDENT_CLUSTERS = {8: 15, 16: 7}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tpu_vmem_bytes(P: int, K: int) -> int:
    """The VMEM the TPU kernel's wrapper counts for (P, K) at its smallest
    tile of 8 rows: D twice and three tiles of Ym, M, x and g rows."""
    return 2 * P * K * 4 + 3 * _TPU_MIN_TILE * (2 * P + 2 * K + 10) * 4


def in_tpu_range(P: int, K: int) -> bool:
    """Whether the TPU kernel's VMEM arithmetic fits (P, K) under its
    default budget: the shapes kernel B1 must take."""
    return tpu_vmem_bytes(P, K) <= _TPU_VMEM_BUDGET


def smem_bytes(bf16: bool, rows: int, slice_rows: int, K: int, seg: int) -> int:
    """Dynamic shared memory of one CTA, as ``make_layout`` in csrc/ista.cu
    lays it out."""
    if bf16:
        kp = _round_up(K, 32)
        ld = kp + 8
        pcp = _round_up(slice_rows, 16)
        sizes = [
            pcp * ld * 2,  # the slice of D
            _BF16_ROWS * ld * 2,  # operand x
            rows * (kp + 8) * 4,  # partial gradient
            max(_BF16_ROWS * (pcp + 8) * 2, rows * (seg + 2 * _HALO) * 4),  # residual / g
        ]
    else:
        kp = _round_up(K, 4)
        sizes = [
            slice_rows * (kp + 4) * 4,
            _F32_ROWS * kp * 4,
            max(rows * (kp + 8), _WARPS * rows * slice_rows) * 4,
            max(slice_rows * 12, rows * (seg + 2 * _HALO)) * 4,
        ]
    sizes.append(2 * rows * seg * 4)  # carried x of the CTA's columns, two copies
    return sum(_round_up(s, 16) for s in sizes) + 2 * _BF16_ROWS * 4


def _stream_kp(bf16: bool, K: int) -> int:
    """K padded as the streamed kernel pads it: to 16 bf16 values or 8 floats."""
    return _round_up(K, 16 if bf16 else 8)


def stream_smem_bytes(bf16: bool, rows: int, K: int, seg: int, resident_rows: int, stages: int,
                      stage_rows: Optional[int] = None) -> int:
    """Dynamic shared memory of one CTA of the streamed kernel, as
    ``make_stream_layout`` in csrc/ista.cu lays it out: the operand copy of
    x (16 rows; f32 12 where rows <= 12, the tiles' rows), the resident rows
    (whole stages), the ring of stages or, after
    the pass, the partial gradient in its place, product 1's partial sums
    and the residual of two stages (or step 3's gradient segment in their
    place), the carried x of the CTA's columns and two mbarriers per slot."""
    esz = 2 if bf16 else 4
    S = stage_rows or _STAGE_ROWS[bf16][-1]
    kp = _stream_kp(bf16, K)
    ld = kp + (8 if bf16 else 4)
    ldg = kp + 8
    xr = _STREAM_ROWS if bf16 or rows > 12 else 12  # rows of x in the tiles
    x = xr * ld * esz
    resident = _round_up(resident_rows, S) * ld * esz
    ring = max(stages * S * ld * esz, rows * ldg * 4)
    part = 2 * (_WARPS if bf16 else 2 * _WARPS) * xr * S * 4  # one sum per warp (f32: 16 warps)
    res = 2 * _STREAM_ROWS * (S + 8) * 2 if bf16 else 2 * S * _STREAM_ROWS * 4
    small = max(_round_up(part, 16) + _round_up(res, 16), _round_up(rows * (seg + 2 * _HALO) * 4, 16))
    xown = 2 * rows * seg * 4
    bars = 2 * _RING * 8  # two mbarriers per ring slot
    return (_round_up(x, 16) + _round_up(resident, 16) + _round_up(ring, 16) + small
            + _round_up(xown, 16) + 2 * _BF16_ROWS * 4 + bars)


def stream_copies_d(bf16: bool, K: int) -> bool:
    """Whether the streamed kernel's launch first copies D for the rows it
    streams (``stream_copies_d`` in csrc/ista.cu): bf16 rounds it once, f32
    with K not a multiple of 4 pads its rows to 16 bytes, the bulk copies'
    alignment."""
    return bf16 or K % 4 != 0


def stream_scratch_floats(P: int, K: int, bf16: bool, stages: int) -> int:
    """Device-memory scratch of a launch of the streamed kernel, in floats:
    with rows to stream and ``stream_copies_d``, that copy (P rows of
    ``lrs_pnp_ista_stream_copy_stride`` values, bf16 two to a float);
    nothing else."""
    if not stages or not stream_copies_d(bf16, K):
        return 0
    return P * _stream_kp(bf16, K) // (2 if bf16 else 1)


def column_groups(seg: int) -> int:
    """f32 product 2 of the column kernel: the groups of rows of D whose
    sums are added in order after the pass (512 threads over ``seg / 4``
    float4 columns)."""
    return _COL_THREADS_F32 // min(seg // 4, _COL_THREADS_F32)


def column_smem_bytes(bf16: bool, rows: int, P: int, seg: int, resident_rows: int) -> int:
    """Dynamic shared memory of one CTA of the column kernel, as
    ``make_column_layout`` in csrc/ista.cu lays it out: the resident rows of
    ``D[:, k_c]``, the CTA's x (bf16: the operand and the carried f32 copy),
    the partial pred and the residual (f32: one buffer [P][tile rows], which
    product 2's group sums take after the pass; bf16: pred [rows][P] in f32,
    whose place product 2's odd half of warps takes, and the residual
    [16][P] in bf16), the gradient step with its halo and the rows'
    scalars."""
    pp = _round_up(P, 16)
    if bf16:
        ldw = seg + 8
        sizes = [_round_up(resident_rows, 16) * ldw * 2, _BF16_ROWS * ldw * 2, rows * seg * 4,
                 rows * max(pp, seg) * 4, _BF16_ROWS * (pp + 8) * 2]
    else:
        rt = 4 if rows <= 4 else 12  # column_tile_rows
        groups = column_groups(seg)
        sizes = [resident_rows * (seg + 4) * 4, rt * seg * 4, 0,
                 max(P * rt, groups * rows * seg if groups > 1 else 0) * 4, 0]
    sizes.append(rows * (seg + 2 * _HALO) * 4)
    return sum(_round_up(s, 16) for s in sizes) + 2 * _BF16_ROWS * 4


def column_copies_d(bf16: bool, K: int, P: int, resident_rows: int) -> bool:
    """Whether a launch of the column kernel first copies D
    (``column_copies_d`` in csrc/ista.cu): f32 pads rows whose K is not a
    multiple of 4 to 16 bytes; bf16 rounds D and its transpose for the rows
    it does not keep resident."""
    return resident_rows < P if bf16 else K % 4 != 0


def column_scratch_floats(P: int, K: int, bf16: bool, resident_rows: int) -> int:
    """Device-memory scratch of a launch of the column kernel, in floats:
    f32, D's rows padded to 8 floats; bf16, D rounded with rows padded to 16
    values and its transpose, [K padded to 16][P padded to 16], two values to
    a float."""
    if not column_copies_d(bf16, K, P, resident_rows):
        return 0
    if bf16:
        kp = _round_up(K, 16)
        return (P * kp + kp * _round_up(P, 16)) // 2
    return P * _round_up(K, 8)


@dataclasses.dataclass(frozen=True)
class IstaPlan:
    """The tiling of one launch of kernel B1."""

    nB: int
    P: int
    K: int
    bf16: bool
    cluster_size: int  # C: CTAs per cluster
    rows: int  # R: block rows per cluster
    n_clusters: int
    resident: int  # clusters the card keeps resident at once
    slice_rows: int  # rows of D per CTA
    seg: int  # columns of x per CTA in step 3
    smem_bytes: int
    # The streamed tilings (the whole slice resident: zero stages).
    resident_rows: int  # rows of each slice kept in shared memory (column tier: of D[:, k_c], of all P)
    stage_rows: int  # rows of D per stage of the ring
    stages: int  # stages of the ring
    tier: str = "resident"  # "resident", "streamed" (the ring) or "column" (columns of D per CTA)

    @property
    def streamed(self) -> bool:
        """Whether the launch takes one of the kernels that may stream D
        (the streamed or the column tier)."""
        return self.tier != "resident"

    @property
    def streamed_rows(self) -> int:
        """Rows of D read from L2 in each iteration: of a whole slice
        through the ring (streamed tier), or of ``D[:, k_c]`` by each CTA
        in each product (column tier)."""
        return (self.P if self.tier == "column" else self.slice_rows) - self.resident_rows

    @property
    def scratch_floats(self) -> int:
        """Device-memory scratch of the launch, in floats."""
        if self.tier == "streamed":
            return stream_scratch_floats(self.P, self.K, self.bf16, self.stages)
        if self.tier == "column":
            return column_scratch_floats(self.P, self.K, self.bf16, self.resident_rows)
        return 0

    @property
    def l2_bytes_per_iteration(self) -> int:
        """Bytes of D one cluster reads through L2 per iteration beyond its
        resident rows (the note in csrc/ista.cu).  Streamed tier: each CTA's
        streamed rows once, each K floats of D, or kp values of its copy
        (``stream_copies_d``).  Column tier: each CTA's rows of ``D[:, k_c]``
        past its resident ones twice, once per product, its columns padded
        to 4 floats (f32) or 16 values (bf16).  0 for the resident kernels."""
        K = self.K
        if self.tier == "streamed":
            rows = sum(max(0, b - a - self.resident_rows) for a, b in self.p_slices())
            if stream_copies_d(self.bf16, K):
                return rows * _stream_kp(self.bf16, K) * (2 if self.bf16 else 4)
            return rows * 4 * K
        if self.tier == "column":
            cols = sum(_round_up(b - a, 16 if self.bf16 else 4) for a, b in self.k_segments())
            return 2 * self.streamed_rows * cols * (2 if self.bf16 else 4)
        return 0

    @property
    def waves(self) -> int:
        return -(-self.n_clusters // self.resident)

    def row_chunks(self):
        """(first, past-last) block row of each cluster."""
        return [(i * self.rows, min(self.nB, (i + 1) * self.rows)) for i in range(self.n_clusters)]

    def p_slices(self):
        """(first, past-last) row of D of each CTA of a cluster; the last
        may be short or empty."""
        return [
            (min(self.P, c * self.slice_rows), min(self.P, (c + 1) * self.slice_rows))
            for c in range(self.cluster_size)
        ]

    def k_segments(self):
        """(first, past-last) column of x that each CTA reduces and denoises."""
        return [
            (min(self.K, c * self.seg), min(self.K, (c + 1) * self.seg))
            for c in range(self.cluster_size)
        ]


_WAY_AROUND = 'SparseProxConfig(backend="xla") runs the plain loop for it'


def _refused(reason: str) -> ValueError:
    return ValueError(f"{reason}; {_WAY_AROUND}")


def _spread(nB: int, rows_max: int, resident: int):
    """(rows per cluster, clusters): as few waves of ``resident`` clusters of
    at most ``rows_max`` rows as cover nB, the rows spread evenly over them."""
    waves = -(-nB // (resident * rows_max))
    rows = -(-nB // min(nB, waves * resident))
    return rows, -(-nB // rows)


def _resident_plan(nB, P, K, bf16, resident, smem_limit, reasons):
    """The tiling with each slice of D resident, or None (reasons appended)."""
    if bf16 and _round_up(K, 32) > _BF16_MAX_K:
        reasons.append(f"K={K} is past the bf16 kernel's {_BF16_MAX_K} columns")
        return None
    for C in (8, 16):
        slice_rows = -(-P // C)
        seg = _round_up(-(-K // C), 4)
        limit = _BF16_MAX_SLICE if bf16 else _F32_MAX_SLICE
        if (_round_up(slice_rows, 16) if bf16 else slice_rows) > limit:
            reasons.append(f"cluster {C}: {slice_rows} rows of D per CTA (> {limit})")
            continue
        if resident.get(C, 0) < 1:
            reasons.append(f"cluster {C}: the card keeps no such cluster resident")
            continue
        fits = [
            r for r in range(_BF16_ROWS if bf16 else _F32_ROWS, 0, -1)
            if smem_bytes(bf16, r, slice_rows, K, seg) <= smem_limit
        ]
        if not fits:
            need = smem_bytes(bf16, 1, slice_rows, K, seg)
            reasons.append(f"cluster {C}: {need} B of shared memory (> {smem_limit})")
            continue
        rows, n_clusters = _spread(nB, fits[0], resident[C])
        return IstaPlan(
            nB=nB, P=P, K=K, bf16=bf16, cluster_size=C, rows=rows,
            n_clusters=n_clusters, resident=resident[C], slice_rows=slice_rows,
            seg=seg, smem_bytes=smem_bytes(bf16, rows, slice_rows, K, seg),
            resident_rows=slice_rows, stage_rows=0, stages=0,
        )
    return None


def _streamed_plan(nB, P, K, bf16, resident, smem_limit, reasons):
    """The streamed tiling, or None (reasons appended).  For each cluster
    size the card keeps resident: the rows spread over as few waves as
    cover nB; the first stage height of ``_STAGE_ROWS`` whose ring fits;
    then the whole slice resident if it fits, else the most whole stages of
    it beside a ring of up to 3 stages.
    Of these the tiling with the fewest waves, then the fewest bytes of D
    that each CTA streams per iteration, then the smaller cluster: on an
    H100 one wave of clusters of 8 beat two waves of 16 at every streamed
    shape of ``chip_smoke.WIDE_SHAPES``, P 576 / K 1152 in bf16 too, where
    the clusters of 16 hold the whole slice and stream nothing
    (scripts/profile_b1_phases.py --cluster)."""
    if _stream_kp(bf16, K) > _STREAM_MAX_K[bf16]:
        reasons.append(f"streamed: K={K} is past its {_STREAM_MAX_K[bf16]} columns "
                       f"({'bf16' if bf16 else 'f32'} partial gradient in registers)")
        return None
    best = None
    for C in (8, 16):
        if resident.get(C, 0) < 1:
            reasons.append(f"streamed, cluster {C}: the card keeps no such cluster resident")
            continue
        slice_rows = -(-P // C)
        seg = _round_up(-(-K // C), 4)
        rows, n_clusters = _spread(nB, _STREAM_ROWS, resident[C])
        # f32 stages of 16 rows keep 4 rows of the partial gradient a thread: K <= 512
        heights = [h for h in _STAGE_ROWS[bf16] if bf16 or h == 8 or _stream_kp(bf16, K) <= 512]
        S = next((h for h in heights if stream_smem_bytes(
            bf16, rows, K, seg, 0, min(_RING, -(-slice_rows // h)), h) <= smem_limit), heights[-1])
        choice = None
        if stream_smem_bytes(bf16, rows, K, seg, slice_rows, 0, S) <= smem_limit:
            choice = (slice_rows, 0)
        else:
            for resident_rows in range((slice_rows - 1) // S * S, -1, -S):
                stages = min(_RING, -(-(slice_rows - resident_rows) // S))
                if stream_smem_bytes(bf16, rows, K, seg, resident_rows, stages, S) <= smem_limit:
                    choice = (resident_rows, stages)
                    break
        if choice is None:
            need = stream_smem_bytes(bf16, rows, K, seg, 0, min(_RING, -(-slice_rows // S)), S)
            reasons.append(f"streamed, cluster {C}: {need} B of shared memory (> {smem_limit})")
            continue
        plan = IstaPlan(
            nB=nB, P=P, K=K, bf16=bf16, cluster_size=C, rows=rows,
            n_clusters=n_clusters, resident=resident[C], slice_rows=slice_rows,
            seg=seg, smem_bytes=stream_smem_bytes(bf16, rows, K, seg, *choice, S),
            resident_rows=choice[0], stage_rows=S, stages=choice[1], tier="streamed",
        )
        key = (plan.waves, plan.l2_bytes_per_iteration // C, C)
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1] if best else None


def _column_resident_rows(bf16, rows, P, seg, smem_limit):
    """The most rows of ``D[:, k_c]`` each CTA keeps resident beside the
    rest of the column kernel's layout: all P, else (bf16) a multiple of 16."""
    if column_smem_bytes(bf16, rows, P, seg, P) <= smem_limit:
        return P
    row_bytes = (seg + 8) * 2 if bf16 else (seg + 4) * 4
    fit = (smem_limit - column_smem_bytes(bf16, rows, P, seg, 0)) // row_bytes
    return min(P - 1, fit // 16 * 16 if bf16 else fit)


def _column_plan(nB, P, K, bf16, resident, smem_limit, reasons):
    """The column tiling (the long-K tail), or None (reasons appended).  For
    each cluster size the card keeps resident: CTA c owns ``seg`` columns of
    D and x (K / C padded to 8 in f32, 16 in bf16) for all P rows and the
    slice of ``slice_rows`` rows (a multiple of 4) of the residual; the most
    rows per cluster whose buffers fit, spread over as few waves as cover
    nB; then as many rows of ``D[:, k_c]`` resident as fit.  Of these, as in
    :func:`_streamed_plan`, the tiling with the fewest waves, then the fewest
    bytes of D each CTA reads from L2 per iteration, then the smaller
    cluster."""
    best = None
    for C in (8, 16):
        if resident.get(C, 0) < 1:
            reasons.append(f"column, cluster {C}: the card keeps no such cluster resident")
            continue
        seg = _round_up(-(-K // C), _COL_SEG_ALIGN[bf16])
        fits = [r for r in range(_COL_ROWS[bf16], 0, -1) if column_smem_bytes(bf16, r, P, seg, 0) <= smem_limit]
        if not fits:
            need = column_smem_bytes(bf16, 1, P, seg, 0)
            reasons.append(f"column, cluster {C}: {need} B of shared memory (> {smem_limit})")
            continue
        rows, n_clusters = _spread(nB, fits[0], resident[C])
        resident_rows = _column_resident_rows(bf16, rows, P, seg, smem_limit)
        plan = IstaPlan(
            nB=nB, P=P, K=K, bf16=bf16, cluster_size=C, rows=rows,
            n_clusters=n_clusters, resident=resident[C], slice_rows=_round_up(-(-P // C), 4),
            seg=seg, smem_bytes=column_smem_bytes(bf16, rows, P, seg, resident_rows),
            resident_rows=resident_rows, stage_rows=0, stages=0, tier="column",
        )
        key = (plan.waves, plan.l2_bytes_per_iteration // C, C)
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1] if best else None


def tile_rows(plan: IstaPlan) -> int:
    """Block rows of the register or mma tile each product runs on, R of
    them real: 16 in bf16; in f32 11 (resident), 12 or 16 (streamed, 16
    past 12 rows), 4 or 12 (column, 12 past 4 rows)."""
    if plan.bf16:
        return _BF16_ROWS
    if plan.tier == "streamed":
        return _STREAM_ROWS if plan.rows > 12 else 12
    if plan.tier == "column":
        return 4 if plan.rows <= 4 else 12
    return _F32_ROWS


def iteration_counts(plan: IstaPlan) -> tuple:
    """What one CTA does in one iteration of ``plan``, as csrc/ista.cu
    lays the work out: (steps, FMAs, bytes of D read from L2, values summed
    through the cluster).  Steps: the resident kernels' steps along K in
    product 1 (f32: each warp an eighth of K; bf16: an mma's k of 16); the
    streamed kernel's consumer steps, one per stage of its slice and two to
    drain the pipeline; the column kernel's rounds of rows of D (64 a round
    in f32, one per group of 8 lanes; 16 in bf16, an mma's k).  FMAs
    as the tiles issue them, padding included: f32 resident product 1 by
    lanes of 32 rows of the slice; f32 column product 1 by groups of 8 lanes
    of 4 columns over 64 rows.  Exchanged: the R x K partial gradient
    (resident, streamed) or the R x P partial prediction (column)."""
    t, P, K, R = tile_rows(plan), plan.P, plan.K, plan.rows
    sl, seg = plan.slice_rows, plan.seg
    l2 = plan.l2_bytes_per_iteration // plan.cluster_size
    if plan.tier == "resident":
        if plan.bf16:
            return -(-K // 16), t * _round_up(K, 32) * 2 * _round_up(sl, 16), l2, R * K
        return -(-K // _WARPS), t * K * (32 * -(-sl // 32) + sl), l2, R * K
    if plan.tier == "streamed":
        S = plan.stage_rows
        return -(-sl // S) + 2, 2 * t * -(-sl // S) * S * (_round_up(K, 16) if plan.bf16 else K), l2, R * K
    if plan.bf16:
        return -(-P // 16), 2 * t * _round_up(P, 16) * _round_up(seg, 16), l2, R * P
    return -(-P // 64), t * (_round_up(P, 64) * 32 * -(-seg // 32) + P * seg), l2, R * P


# One wave's iteration of each tier and operand type takes a + b steps + c
# FMAs + d bytes + e values (iteration_counts) microseconds: (a, b per step,
# c per million FMAs, d per MB of L2, e per thousand values), fitted by
# scripts/fit_b1_plan.py to the sweeps of scripts/time_b1.py --tiers
# (scripts/b1_tier_sweeps.jsonl) on an NVIDIA H100 80GB HBM3, 700.00 W; the
# times are in PERF.md section 6, "B1 across its tiers".
_COST_US = {
    ("resident", False): (3.82, 0.05291, 3.486, 0.0, 0.399),
    ("resident", True): (3.658, 0.06827, 0.5336, 0.0, 0.3622),
    ("streamed", False): (1.301, 1.258, 5.686, 13.74, 0.4941),
    ("streamed", True): (1.937, 0.8863, 0.38, 24.46, 0.4617),
    ("column", False): (6.187, 0.219, 10.26, 5.098, 0.5214),
    ("column", True): (5.351, 0.06954, 1.632, 39.05, 0.3336),
}
# The largest relative error of each group's fit over those sweeps.
_FIT_ERROR = {
    ("resident", False): 0.162, ("resident", True): 0.135,
    ("streamed", False): 0.134, ("streamed", True): 0.133,
    ("column", False): 0.241, ("column", True): 0.173,
}
# The shapes (nB, P, K, operand types: f32, bf16) whose every candidate
# those sweeps timed: the paths' shapes (chip_smoke.TIER_SHAPES), the short
# launches of the card tests and of chip_smoke.py, the tier-named cases of
# tests/test_torch_cuda.py and the test shapes whose pick the rule moves.
SWEPT_SHAPES = frozenset(
    (nB, P, K, bf16)
    for nB, P, K, types in (
        (2, 36, 700, "f"), (3, 16, 3000, "f"), (3, 100, 1000, "f"), (5, 200, 700, "fb"), (5, 1296, 1022, "f"),
        (7, 1296, 1000, "f"), (8, 64, 1100, "fb"), (9, 1296, 1030, "b"), (9, 1700, 30, "f"), (11, 100, 300, "fb"),
        (11, 1300, 600, "f"), (13, 1296, 512, "fb"), (13, 1700, 40, "f"), (14, 576, 1152, "f"),
        (17, 576, 1152, "fb"), (20, 48, 32, "fb"), (20, 2704, 64, "f"), (21, 2704, 512, "f"),
        (29, 1296, 512, "fb"), (40, 48, 32, "fb"), (40, 144, 1024, "b"), (40, 1296, 1152, "f"),
        (72, 576, 1152, "fb"), (72, 1296, 512, "fb"), (132, 1600, 512, "fb"), (144, 400, 1024, "fb"),
        (144, 529, 1024, "fb"), (144, 576, 1152, "fb"), (144, 1296, 512, "fb"), (144, 1296, 640, "fb"),
        (144, 1296, 1004, "f"), (144, 1296, 1024, "fb"), (144, 1296, 1152, "b"), (144, 2304, 512, "fb"),
        (144, 2704, 512, "fb"), (165, 48, 32, "f"), (166, 48, 32, "f"), (216, 36, 48, "fb"), (240, 48, 32, "fb"),
        (240, 1296, 1024, "f"), (240, 1600, 512, "fb"), (288, 1296, 512, "fb"), (324, 576, 512, "fb"),
        (576, 1296, 512, "fb"), (1296, 576, 512, "fb"), (2304, 1296, 512, "fb"),
    )
    for bf16 in (False, True)
    if "fb"[bf16] in types
)
# At a swept shape a later candidate of plan_candidates replaces an earlier
# one only when it is predicted faster by more than this share: in those
# sweeps three quarters of the candidates' medians moved by less between two
# calls (2.7%), and the picks were held to the timings.  Elsewhere it must be
# predicted faster by more than the larger fit error of the two tiers' groups.
TIE_MARGIN = 0.03


def predicted_ms(plan: IstaPlan, n_iter: int = 100) -> float:
    """The predicted time of a launch of ``plan`` with ``n_iter``
    iterations on an H100: its waves times one wave's iteration
    (``_COST_US``) times ``n_iter``."""
    steps, fmas, l2, exchanged = iteration_counts(plan)
    a, b, c, d, e = _COST_US[plan.tier, plan.bf16]
    us = a + b * steps + c * fmas / 1e6 + d * l2 / 1e6 + e * exchanged / 1e3
    return plan.waves * n_iter * us / 1e3


def plan_candidates(
    nB: int, P: int, K: int, bf16: bool,
    resident: Mapping[int, int] = H100_RESIDENT_CLUSTERS,
    smem_limit: int = _MAX_SMEM_BYTES,
    reasons: Optional[list] = None,
) -> list:
    """Every tier's tiling that takes (nB, P, K, operand type), in the order
    resident (:func:`_resident_plan`), streamed (:func:`_streamed_plan`),
    column (:func:`_column_plan`); the two streaming tiers only inside the
    TPU kernel's range (:func:`in_tpu_range`).  Why a tier does not take the
    shape is appended to ``reasons``."""
    reasons = [] if reasons is None else reasons
    plans = [_resident_plan(nB, P, K, bf16, resident, smem_limit, reasons)]
    if in_tpu_range(P, K):
        plans += [_streamed_plan(nB, P, K, bf16, resident, smem_limit, reasons),
                  _column_plan(nB, P, K, bf16, resident, smem_limit, reasons)]
    elif plans[0] is None:
        reasons.append(
            f"past the TPU kernel's range: {tpu_vmem_bytes(P, K)} B of VMEM at its smallest tile "
            f"(> {_TPU_VMEM_BUDGET})"
        )
    return [p for p in plans if p is not None]


def pick_margin(kept: IstaPlan, plan: IstaPlan) -> float:
    """The share by which ``plan`` must be predicted faster than ``kept``
    to replace it: ``TIE_MARGIN`` at the shapes of ``SWEPT_SHAPES``, else
    the larger ``_FIT_ERROR`` of their two groups."""
    if (plan.nB, plan.P, plan.K, plan.bf16) in SWEPT_SHAPES:
        return TIE_MARGIN
    return max(_FIT_ERROR[kept.tier, kept.bf16], _FIT_ERROR[plan.tier, plan.bf16])


def pick_plan(plans: list) -> IstaPlan:
    """The candidate with the least predicted time, going through ``plans``
    in order: a later one replaces the one kept only when it is predicted
    faster by more than :func:`pick_margin`, so ties keep the earlier tier."""
    best = plans[0]
    for plan in plans[1:]:
        if predicted_ms(plan) < (1.0 - pick_margin(best, plan)) * predicted_ms(best):
            best = plan
    return best


def plan_ista(
    nB: int, P: int, K: int, bf16: bool,
    resident: Mapping[int, int] = H100_RESIDENT_CLUSTERS,
    smem_limit: int = _MAX_SMEM_BYTES,
) -> IstaPlan:
    """Choose the tiling for (nB, P, K, operand type).

    Each tier that takes the shape offers its tiling
    (:func:`plan_candidates`): the kernel with each slice of D resident
    (the smallest cluster whose slice fits the register tiles and
    ``smem_limit`` bytes of shared memory, the most rows per cluster that
    fit beside it, then as few waves of ``resident`` clusters as cover nB,
    with the rows spread evenly over them), the streamed kernel
    (:func:`_streamed_plan`) and the column kernel (:func:`_column_plan`):
    between them every shape in the TPU kernel's range
    (:func:`in_tpu_range`).  The plan is the one with the least predicted
    time (:func:`pick_plan`, :func:`predicted_ms`), a pure function of the
    shape and the card's resident clusters.  All run one CTA per SM, so the
    card keeps as many of their clusters resident.  Raises ValueError with
    the reason for a shape none takes, which names ``backend="xla"`` as the
    way around it."""
    if nB < 1 or P < 1 or K < 6:
        raise _refused(f"needs nB >= 1, P >= 1 and K >= 6 (nB={nB}, P={P}, K={K})")
    reasons = []
    plans = plan_candidates(nB, P, K, bf16, resident, smem_limit, reasons)
    if plans:
        return pick_plan(plans)
    raise _refused(
        f"kernel B1 does not take P={P}, K={K} with {'bf16' if bf16 else 'f32'} operands: "
        + "; ".join(reasons)
    )


def share_plan(whole: IstaPlan, nB: int) -> IstaPlan:
    """The tiling of ``nB`` of ``whole``'s rows launched on their own (one
    rank's share of the rows under ``patch``): ``whole``'s tier, cluster
    size, slices, segments, stages and register tiles (:func:`tile_rows`),
    the rows spread over as few waves as cover them, at most ``whole.rows``
    per cluster; where fewer rows per cluster would take a smaller tile,
    ``whole.rows`` each.  Every row then meets the tiles and the order of
    sums it meets in ``whole``, which :func:`plan_ista` at ``nB`` may not
    give (another tier, cluster size or tile wins at fewer rows)."""
    rows, n_clusters = _spread(nB, whole.rows, whole.resident)
    share = dataclasses.replace(whole, nB=nB, rows=rows, n_clusters=n_clusters)
    if tile_rows(share) != tile_rows(whole):
        share = dataclasses.replace(whole, nB=nB, n_clusters=-(-nB // whole.rows))
    return dataclasses.replace(share, smem_bytes=plan_smem_bytes(share))


def plan_smem_bytes(plan: IstaPlan) -> int:
    """The shared-memory bytes that ``plan``'s tier lays out for its rows,
    slices, segments and stages."""
    if plan.tier == "streamed":
        return stream_smem_bytes(plan.bf16, plan.rows, plan.K, plan.seg, plan.resident_rows, plan.stages,
                                 plan.stage_rows)
    if plan.tier == "column":
        return column_smem_bytes(plan.bf16, plan.rows, plan.P, plan.seg, plan.resident_rows)
    return smem_bytes(plan.bf16, plan.rows, plan.slice_rows, plan.K, plan.seg)


class FusedIstaKernel:
    """Builds, loads and launches ``csrc/ista.cu``.

    ``launches`` counts the launches of the fused loop: one per call that
    reaches the kernel outside a CUDA graph capture, and the launches a
    captured graph holds each time it is replayed (:meth:`replayed`).  A
    call during a capture records a launch into the graph and adds to
    ``captured`` instead.  ``last_plan`` is the tiling of the latest launch,
    replays included."""

    source = _CSRC / "ista.cu"
    build_dir = _CSRC / "build"

    def __init__(self, extra_flags: tuple = ()):
        self.flags = _NVCC_FLAGS + tuple(extra_flags)
        self.launches = 0
        self.captured = 0
        self.last_plan: Optional[IstaPlan] = None
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._resident: dict = {}
        self._plans: dict = {}
        self._share_plans: dict = {}
        self._whole: Optional[int] = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(self.flags).encode()
        ).hexdigest()[:16]
        return self.build_dir / f"libista_{digest}.so"

    def build(self) -> ctypes.CDLL:
        """Compile the source if its library is not built yet, then load it."""
        if self._lib is not None:
            return self._lib
        lib_path = self.library_path()
        if not lib_path.exists():
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {self.source}:\n"
                    f"{self.build_log}"
                )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        lib.lrs_pnp_ista_launch.argtypes = [ptr] * 4 + [ctypes.c_float, ptr] + [c_int] * 10 + [ptr]
        lib.lrs_pnp_ista_launch.restype = c_int
        lib.lrs_pnp_ista_stream_launch.argtypes = (
            [ptr] * 4 + [ctypes.c_float, ptr, ptr] + [c_int] * 13 + [ptr])
        lib.lrs_pnp_ista_stream_launch.restype = c_int
        lib.lrs_pnp_ista_column_launch.argtypes = (
            [ptr] * 4 + [ctypes.c_float, ptr, ptr] + [c_int] * 11 + [ptr])
        lib.lrs_pnp_ista_column_launch.restype = c_int
        lib.lrs_pnp_ista_smem_bytes.argtypes = [c_int] * 5
        lib.lrs_pnp_ista_smem_bytes.restype = c_int
        lib.lrs_pnp_ista_stream_smem_bytes.argtypes = [c_int] * 7
        lib.lrs_pnp_ista_stream_smem_bytes.restype = c_int
        lib.lrs_pnp_ista_stream_copy_stride.argtypes = [c_int] * 2
        lib.lrs_pnp_ista_stream_copy_stride.restype = c_int
        lib.lrs_pnp_ista_column_smem_bytes.argtypes = [c_int] * 5
        lib.lrs_pnp_ista_column_smem_bytes.restype = c_int
        lib.lrs_pnp_ista_column_scratch_floats.argtypes = [c_int] * 4
        lib.lrs_pnp_ista_column_scratch_floats.restype = ctypes.c_longlong
        lib.lrs_pnp_ista_max_clusters.argtypes = [c_int] * 3
        lib.lrs_pnp_ista_max_clusters.restype = c_int
        self._lib = lib
        return lib

    def resident_clusters(self, bf16: bool) -> dict:
        """Clusters of 8 and of 16 CTAs that the current card keeps resident
        at the largest shared-memory request, asked once per operand type."""
        if bf16 not in self._resident:
            lib = self.build()
            self._resident[bf16] = {
                C: lib.lrs_pnp_ista_max_clusters(int(bf16), C, _MAX_SMEM_BYTES) for C in (8, 16)
            }
        return self._resident[bf16]

    def plan(self, nB: int, P: int, K: int, bf16: bool) -> IstaPlan:
        """:func:`plan_ista` for the card this process runs on, kept per
        shape; inside :meth:`shares_of`, the share of the whole's plan."""
        key = (nB, P, K, bool(bf16))
        if self._whole not in (None, nB):
            share = key + (self._whole,)
            if share not in self._share_plans:
                self._share_plans[share] = share_plan(self.plan(self._whole, P, K, bf16), nB)
            return self._share_plans[share]
        if key not in self._plans:
            self._plans[key] = plan_ista(nB, P, K, bf16, self.resident_clusters(bf16))
        return self._plans[key]

    @contextlib.contextmanager
    def forcing(self, *plans: IstaPlan):
        """Inside the block launches at each plan's shape take that plan in
        place of :func:`plan_ista`'s pick: how the card tests and the tier
        sweep hold every candidate of :func:`plan_candidates` to the plain
        loop and time it against the others."""
        saved = dict(self._plans)
        self._plans.update({(p.nB, p.P, p.K, p.bf16): p for p in plans})
        try:
            yield
        finally:
            self._plans.clear()
            self._plans.update(saved)

    @contextlib.contextmanager
    def shares_of(self, nB: int):
        """Inside the block every launch takes its rows as a share of ``nB``
        rows (:func:`share_plan` of the plan at ``nB``): the sharded sparse
        prox launches each rank's rows so, and the ranks' rows then equal one
        launch over all ``nB`` rows bit for bit."""
        saved, self._whole = self._whole, nB
        try:
            yield
        finally:
            self._whole = saved

    def launch(
        self,
        y: torch.Tensor,  # (nB, P) target blocks
        m: torch.Tensor,  # (nB, P) mask
        d: torch.Tensor,  # (P, K) dictionary
        alpha: torch.Tensor,  # (nB,) step sizes
        h_coef: float,  # the NLM's h is h_coef / (2 alpha)
        n_iter: int,
        bf16: bool,
    ) -> torch.Tensor:
        """Run the fused loop on the current stream; returns x (nB, K).  The
        kernel masks the targets and derives 1/alpha and the NLM's constants
        itself, so the call launches nothing else.  The first call of a
        shape builds the library, asks the card for its resident clusters
        and sets the kernel's attributes; a call during a CUDA graph
        capture after that only records the launch.  ``h_coef`` and
        ``n_iter`` are passed by value, so a captured launch keeps the
        config's constants."""
        nB, P = y.shape
        K = d.shape[1]
        device = y.device
        for name, t, shape in (
            ("y", y, (nB, P)), ("m", m, (nB, P)), ("d", d, (P, K)), ("alpha", alpha, (nB,)),
        ):
            if t.device != device or t.device.type != "cuda":
                raise ValueError(f"{name} must be on the CUDA device {device}, got {t.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if n_iter < 0:
            raise ValueError(f"needs n_iter >= 0 (n_iter={n_iter})")
        bf16 = bool(bf16)
        with torch.cuda.device(device):
            lib = self.build()
            plan = self.plan(nB, P, K, bf16)
            if plan.tier == "streamed":
                laid_out = lib.lrs_pnp_ista_stream_smem_bytes(
                    int(bf16), plan.rows, K, plan.seg, plan.resident_rows, plan.stages, plan.stage_rows)
                stride = lib.lrs_pnp_ista_stream_copy_stride(int(bf16), K)
                scratch = P * stride // (2 if bf16 else 1) if plan.stages else 0
            elif plan.tier == "column":
                laid_out = lib.lrs_pnp_ista_column_smem_bytes(int(bf16), plan.rows, P, plan.seg, plan.resident_rows)
                scratch = lib.lrs_pnp_ista_column_scratch_floats(int(bf16), P, K, plan.resident_rows)
            else:
                laid_out = lib.lrs_pnp_ista_smem_bytes(int(bf16), plan.rows, plan.slice_rows, K, plan.seg)
                scratch = 0
            if scratch != plan.scratch_floats:
                raise RuntimeError(
                    f"the plan counts {plan.scratch_floats} floats of scratch, the kernel {scratch}")
            if laid_out != plan.smem_bytes:
                raise RuntimeError(f"the plan counts {plan.smem_bytes} B of shared memory, the kernel {laid_out}")
            out = torch.empty((nB, K), dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device).cuda_stream
            head = (y.data_ptr(), m.data_ptr(), d.data_ptr(), alpha.data_ptr(), float(h_coef), out.data_ptr())
            tail = (nB, P, K, int(n_iter), int(bf16), plan.cluster_size, plan.n_clusters, plan.rows,
                    plan.slice_rows, plan.seg)
            # the streaming tiers first copy D into this scratch (stream_copies_d,
            # column_copies_d); allocated inside a capture, it stays the graph's
            copy = None
            if plan.scratch_floats:
                copy = (torch.empty(2 * plan.scratch_floats, dtype=torch.bfloat16, device=device) if bf16
                        else torch.empty(plan.scratch_floats, dtype=torch.float32, device=device))
            copy_ptr = None if copy is None else copy.data_ptr()
            if plan.tier == "streamed":
                err = lib.lrs_pnp_ista_stream_launch(
                    *head, copy_ptr, *tail, plan.resident_rows, plan.stages, plan.stage_rows, stream)
            elif plan.tier == "column":
                err = lib.lrs_pnp_ista_column_launch(*head, copy_ptr, *tail, plan.resident_rows, stream)
            else:
                err = lib.lrs_pnp_ista_launch(*head, *tail, stream)
        if err != 0:
            raise RuntimeError(
                f"pnp_ista kernel launch refused: cudaError_t {err} for {plan.n_clusters} clusters "
                f"of {plan.cluster_size} CTAs with {plan.smem_bytes} B of shared memory each"
            )
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        self.last_plan = plan
        return out

    def replayed(self, n: int, plan: Optional[IstaPlan] = None) -> None:
        """Count the ``n`` launches of a captured graph that was just
        replayed, the last of them with the tiling ``plan``."""
        self.launches += n
        if n:
            self.last_plan = plan


ISTA_KERNEL = FusedIstaKernel()
