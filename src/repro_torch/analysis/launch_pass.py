"""Kernel-launch pass: launch geometry, shared memory and MVoxel bank
layout (the twin of ``repro.analysis.pallas_pass``).

Every CUDA kernel of the port (B1-B6) is planned at representative shapes,
the arms' shapes of ``PERF.md`` §6, chosen so that every branch of every
plan is taken. Each launch is a :class:`LaunchRecord`: kernel, C entry,
grid, block, dynamic shared memory and, read off the card, static shared
memory, registers per thread and the estimated occupancy.

- :func:`plan_launches` derives the records from the port's plan functions
  (``gather_trilerp.gather_grid`` / ``gather_smem_bytes`` /
  ``per_seg_staging``, ``streaming_pipeline.dual_grid``,
  ``fused_nerf_mlp.mlp_plan`` / ``smem_bytes``,
  ``flash_attention.decode_split_plan``). Where the geometry is computed
  in C (B6's grids and shared memory, B2's template grid, B4's grid) this
  module keeps a Python twin of the C formula, named after it.
- :func:`recorded_launches` (the card only) runs every wrapper once at the
  same shapes under ``torch.profiler`` with CUDA activity and reads each
  kernel event's ``grid``, ``block``, ``shared memory`` and ``registers
  per thread`` from the exported trace: what each launch really got. The
  trace's shared memory is static plus dynamic; the static part of each
  kernel is read from ``ptxas -v``'s build log. The trace's occupancy
  estimate reads 0 for a launch past 48 KiB of dynamic shared memory (it
  does not see the opt-in), so each record also carries the resident warps
  of the occupancy twin (:func:`occupancy`).

Rules:

- ``kernel-launch-coverage``  grid x block covers each row of the launch's
                              rows exactly once (a CTA column per row
                              range, a grid-stride loop over tiles, one CTA
                              row per MVoxel / head / batch row), and on
                              the card every launch got its plan's grid,
                              block and dynamic shared memory (twin of
                              ``pallas-block-divisibility``).
- ``kernel-smem-budget``      static + dynamic shared memory at most one
                              block's opt-in limit (the card's
                              ``shared_memory_per_block_optin``, else
                              232,448 bytes), at most 1,024 threads a
                              block, grid y and z at most 65,535 (twin of
                              ``pallas-vmem-budget``).
- ``mvoxel-bank-conflict``    recompute the bank-conflict factor of every
                              registered ``mvoxel_layout`` from its row
                              permutation (independent of
                              ``streaming.bank_conflict_factor``):
                              ``bank_interleaved`` must be exactly 1.0 and
                              a true permutation; ``identity``'s known 3.0
                              is recorded, not gated.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.findings import Finding, source_anchor

ALL_RULES = ("kernel-launch-coverage", "kernel-smem-budget",
             "mvoxel-bank-conflict")

SMEM_OPTIN_BYTES = 232448  # one H100 block's opt-in shared memory
MAX_THREADS = 1024
MAX_GRID_YZ = 65535
H100 = dict(sms=132, smem_optin=SMEM_OPTIN_BYTES, smem_per_sm=233472,
            regs_per_sm=65536, threads_per_sm=2048)
RESERVED_SMEM = 1024  # shared memory the runtime keeps per resident block
MAX_BLOCKS_PER_SM = 32
REG_ALLOC_UNIT = 256  # registers are allocated per warp in units of 256
# B2's templates: the most registers ``__launch_bounds__(256, H <= 64 ? 2 :
# 1)`` lets ptxas use, the planning value where no build log says more
B2_REGS_CAP = {32: 128, 64: 128, 128: 255}
DIR_WIDTH = 9  # the radiance MLP's direction code

# C constants the twins below follow (csrc/*.cu)
B4_THREADS = 256  # kThreads, gather_trilerp_per_seg.cu
B2_THREADS = 256  # kThreadsPerCta / kRtThreads, fused_nerf_mlp.cu
B2_TILE_ROWS = 16  # samples of one warp's tile in the templates
TILE_BQ, TILE_BK, TILE_THREADS = 64, 32, 256  # flash_attention.cu tile
MMA_BQ, MMA_BK, MMA_THREADS = 64, 64, 128  # flash_attention.cu mma
DECODE_GMAX = 8  # kGMax: query heads one decode CTA serves

KERNEL_NAMES = ("gather_trilerp_kernel", "gather_trilerp_per_seg_kernel",
                "fused_gather_dual_kernel",
                "fused_gather_dual_per_seg_kernel", "fused_nerf_mlp_kernel",
                "fused_nerf_mlp_rt_kernel", "flash_tile_kernel",
                "flash_mma_kernel", "flash_decode_split_kernel",
                "flash_decode_combine_kernel")


@dataclasses.dataclass
class LaunchRecord:
    """One kernel launch. ``cover`` holds the rows the launch must cover,
    each ``(what, need, unit, count, stride)``: ``count`` CTAs (or CTA
    columns) of ``unit`` rows must cover ``need`` rows exactly once
    (``stride``: a grid-stride loop, so 1 <= count <= ceil(need / unit));
    ``exact`` holds ``(what, spec, want)``: a grid or block dimension that
    must equal ``want``. A ``spec`` is ``("grid"|"block", axis[, minus])``
    or ``("const", value)``, read from the record's own grid and block."""

    kernel: str
    entry: str
    case: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    dynamic_smem: int
    cover: Tuple = ()
    exact: Tuple = ()
    path: str = "<unknown>"
    line: int = 1
    static_smem: Optional[int] = None
    registers: Optional[int] = None
    occupancy_pct: Optional[float] = None  # the trace's estimate
    occupancy_model_pct: Optional[float] = None  # resident warps, the twin
    source: str = "plan"  # "plan" or "trace"
    # the launch count its wrapper adds to: the kernel source's name, and
    # B6's route (``flash_attention.prefill_mma``)
    counter: str = ""

    @property
    def smem(self) -> int:
        return self.dynamic_smem + (self.static_smem or 0)

    def row(self) -> Dict[str, Any]:
        """The record as a JSON row (coverage specs left out)."""
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dataclasses.asdict(self).items()
                if k not in ("cover", "exact")}


def _spec(spec, rec: LaunchRecord) -> int:
    kind = spec[0]
    if kind == "const":
        return int(spec[1])
    dims = rec.grid if kind == "grid" else rec.block
    return dims[spec[1]] - (spec[2] if len(spec) > 2 else 0)


def check_launch(rec: LaunchRecord, limit: int = SMEM_OPTIN_BYTES
                 ) -> List[Finding]:
    """Coverage and budget findings for one launch."""
    out: List[Finding] = []
    name = f"{rec.kernel} ({rec.case})"
    for what, need, unit, count, stride in rec.cover:
        u, c = _spec(unit, rec), _spec(count, rec)
        if stride:
            ok = u > 0 and 1 <= c <= max(1, -(-need // u))
            why = (f"{c} CTAs of a grid-stride loop over {need} {what} "
                   f"{u} a CTA (want 1..{max(1, -(-need // max(u, 1)))})")
        else:
            ok = u > 0 and c * u >= need and (c - 1) * u < need
            why = (f"{c} x {u} covers {c * u} of {need} {what}: not "
                   "every row exactly once")
        if not ok:
            out.append(Finding("kernel-launch-coverage", rec.path, rec.line,
                               0, f"{name}: {why}"))
    for what, spec, want in rec.exact:
        got = _spec(spec, rec)
        if got != want:
            out.append(Finding("kernel-launch-coverage", rec.path, rec.line,
                               0, f"{name}: {what} {got}, want {want}"))
    threads = rec.block[0] * rec.block[1] * rec.block[2]
    if rec.smem > limit:
        out.append(Finding(
            "kernel-smem-budget", rec.path, rec.line, 0,
            f"{name}: {rec.smem} bytes of shared memory (dynamic "
            f"{rec.dynamic_smem} + static {rec.static_smem or 0}) exceed "
            f"one block's {limit}"))
    if threads > MAX_THREADS:
        out.append(Finding("kernel-smem-budget", rec.path, rec.line, 0,
                           f"{name}: {threads} threads a block > "
                           f"{MAX_THREADS}"))
    if rec.grid[1] > MAX_GRID_YZ or rec.grid[2] > MAX_GRID_YZ:
        out.append(Finding("kernel-smem-budget", rec.path, rec.line, 0,
                           f"{name}: grid {rec.grid}: y and z take at most "
                           f"{MAX_GRID_YZ}"))
    return out


# ---------------------------------------------------------------------------
# representative shapes (PERF.md section 6's arms), every plan branch
# ---------------------------------------------------------------------------

CASES: Tuple[Dict[str, Any], ...] = (
    # B1: gather_grid's 256-row CTAs and a cap under 256 (64-row CTAs),
    # gather_smem_bytes staged and in place
    dict(kind="B1", case="arm A [216,729,4] ids [216,512,8]", num_mv=216,
         c=4, cap=512, num_seg=1, dtype="float32"),
    dict(kind="B1", case="arm B [512,729,8] ids [512,512,8]", num_mv=512,
         c=8, cap=512, num_seg=1, dtype="float32"),
    dict(kind="B1", case="4 segments, cap 64, bf16 [216,729,4]",
         num_mv=216, c=4, cap=64, num_seg=4, dtype="bfloat16"),
    dict(kind="B1", case="cicero-dvgo [8000,729,12] ids [8000,512,8]",
         num_mv=8000, c=12, cap=512, num_seg=1, dtype="float32"),
    dict(kind="B1", case="read in place [216,729,80]", num_mv=216, c=80,
         cap=512, num_seg=1, dtype="float32"),
    # B2: the tensor-core templates (32/64 padded, 128) and the run-time-H
    # mode with its hidden tile in shared memory and in global scratch
    dict(kind="B2", case="arm B S 131072 C 8 H 64", s=131072, c=8, h=64),
    dict(kind="B2", case="pooled fill S 4096 C 8 H 64", s=4096, c=8, h=64),
    dict(kind="B2", case="cicero-tensorf S 131072 C 27 H 64", s=131072,
         c=27, h=64),
    dict(kind="B2", case="C5 S 131072 C 8 H 48 (padded to 64)", s=131072,
         c=8, h=48),
    dict(kind="B2", case="reference S 64 C 4 H 128", s=64, c=4, h=128),
    dict(kind="B2", case="C5 S 131072 C 8 H 160 (run-time H)", s=131072,
         c=8, h=160),
    dict(kind="B2", case="S 4096 C 8 H 1024 (run-time H, scratch)", s=4096,
         c=8, h=1024),
    # B3: arm C's one segment, arm D's four, 64-row CTAs, in place
    dict(kind="B3", case="arm C [216,729,4] caps 512/1024", num_mv=216, c=4,
         cap_h=512, cap_r=1024, num_seg=1),
    dict(kind="B3", case="arm D [512,729,8] 4 segments caps 512/1024",
         num_mv=512, c=8, cap_h=512, cap_r=1024, num_seg=4),
    dict(kind="B3", case="reference grid 16 [8,729,4] caps 32/64", num_mv=8,
         c=4, cap_h=32, cap_r=64, num_seg=1),
    dict(kind="B3", case="read in place [216,729,80] caps 512/1024",
         num_mv=216, c=80, cap_h=512, cap_r=1024, num_seg=1),
    # B4 / B5: arm E's pages under the map [0, 1, 0, 2], staged and in
    # place
    dict(kind="B4", case="pages [4,216,729,4] map [0,1,0,2] cap 512",
         pages=4, num_mv=216, c=4, cap=512),
    dict(kind="B4", case="pages [4,216,729,40] read in place cap 512",
         pages=4, num_mv=216, c=40, cap=512),
    dict(kind="B5", case="pages [4,216,729,4] map [0,1,0,2] caps 512/1024",
         pages=4, num_mv=216, c=4, cap_h=512, cap_r=1024),
    dict(kind="B5", case="pages [4,216,729,40] in place caps 512/1024",
         pages=4, num_mv=216, c=40, cap_h=512, cap_r=1024),
    # B6: both prefill kernels, with and without a band, and the split-KV
    # decode with its combine in both dtypes
    dict(kind="B6", case="arm F prefill bf16 [1,40,2048,128]/[1,8,2048,128]",
         b=1, h=40, kvh=8, sq=2048, sk=2048, d=128, dtype="bfloat16",
         causal=True),
    dict(kind="B6", case="arm F prefill f32 [1,40,2048,128]/[1,8,2048,128]",
         b=1, h=40, kvh=8, sq=2048, sk=2048, d=128, dtype="float32",
         causal=True),
    dict(kind="B6", case="whisper encoder bf16 non-causal [4,12,1500,64]",
         b=4, h=12, kvh=12, sq=1500, sk=1500, d=64, dtype="bfloat16",
         causal=False),
    dict(kind="B6", case="window 64 bf16 [1,40,129,128]", b=1, h=40, kvh=8,
         sq=129, sk=129, d=128, dtype="bfloat16", causal=True, window=64),
    dict(kind="B6", case="window 64 f32 [1,40,129,128]", b=1, h=40, kvh=8,
         sq=129, sk=129, d=128, dtype="float32", causal=True, window=64),
    dict(kind="B6", case="softcap 30 bf16 [1,40,2048,128]", b=1, h=40, kvh=8,
         sq=2048, sk=2048, d=128, dtype="bfloat16", causal=True,
         softcap=30.0),
    dict(kind="B6", case="decode bf16 q [4,40,1,128] cache [4,8,2084,128] "
         "kv_len 2049", b=4, h=40, kvh=8, sq=1, sk=2084, d=128,
         dtype="bfloat16", causal=False, kv_len=2049),
    dict(kind="B6", case="decode f32 q [4,40,1,128] cache [4,8,2084,128] "
         "kv_len 2049", b=4, h=40, kvh=8, sq=1, sk=2084, d=128,
         dtype="float32", causal=False, kv_len=2049),
)

_ELEM = {"float32": 4, "bfloat16": 2}
_TAG = {"float32": "f32", "bfloat16": "bf16"}


# ---------------------------------------------------------------------------
# Python twins of the C formulas
# ---------------------------------------------------------------------------


def occupancy(threads: int, registers: int, smem: int,
              props: Dict[str, int] = H100) -> int:
    """Resident CTAs an SM, the twin of
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on Hopper (B2's
    template grid, ``launch`` in ``csrc/fused_nerf_mlp.cu``): the least of
    the thread, register, shared-memory and CTA limits."""
    warps = -(-threads // 32)
    by_threads = props["threads_per_sm"] // (warps * 32)
    per_warp = -(-registers * 32 // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
    by_regs = (props["regs_per_sm"] // per_warp) // warps
    by_smem = (props["smem_per_sm"] // (smem + RESERVED_SMEM)
               if smem > 0 else MAX_BLOCKS_PER_SM)
    return max(0, min(by_threads, by_regs, by_smem, MAX_BLOCKS_PER_SM))


def b2_template_grid(s: int, smem: int, registers: int,
                     props: Dict[str, int] = H100) -> int:
    """B2's template grid (``launch`` in ``csrc/fused_nerf_mlp.cu``): one
    warp per 16-sample tile, no more CTAs than are resident at once."""
    tiles = -(-s // B2_TILE_ROWS)
    warps = B2_THREADS // 32
    occ = occupancy(B2_THREADS, registers, smem, props) or 1
    return min(-(-tiles // warps), occ * props["sms"])


def b6_tile_smem(d: int) -> int:
    """``launch_tile``'s shared memory (``csrc/flash_attention.cu``)."""
    return 4 * (TILE_BQ * (d + 1) + TILE_BK * (d + 1) + TILE_BK * d
                + TILE_BQ * (TILE_BK + 1))


def b6_mma_smem(d: int) -> int:
    """``MmaGeom<D>::kSmem``: bf16 rows of D + 8 for the query tile and
    two double-buffered key and value tiles."""
    return 2 * (d + 8) * (MMA_BQ + 4 * MMA_BK)


def b6_decode_smem(d: int, dtype: str) -> int:
    """``DecodeGeom<T, D>::kSmem``: two double-buffered K/V tiles and the
    group's scores."""
    bk = 32 if (dtype == "float32" and d == 128) else 64
    return 4 * bk * d * _ELEM[dtype] + DECODE_GMAX * bk * 4


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------


def _gather(case, root) -> List[LaunchRecord]:
    from repro_torch.kernels import gather_trilerp as gt

    plan = gt.gather_grid(case["num_mv"], case["cap"])
    path, line = source_anchor(gt.gather_grid, root)
    return [LaunchRecord(
        "gather_trilerp_kernel", f"gather_trilerp_{_TAG[case['dtype']]}",
        case["case"], (plan.grid[0], plan.grid[1], 1), (plan.threads, 1, 1),
        gt.gather_smem_bytes(729, case["c"], _ELEM[case["dtype"]]),
        cover=(("RIT rows of an MVoxel", case["cap"], ("block", 0),
                ("grid", 0), False),),
        exact=(("MVoxels (grid y)", ("grid", 1), case["num_mv"]),),
        path=path, line=line, counter=gt.KERNEL.name)]


def _dual(case, root, per_seg: bool) -> List[LaunchRecord]:
    from repro_torch.kernels import gather_trilerp as gt
    from repro_torch.kernels import streaming_pipeline as sp

    plan = sp.dual_grid(case["num_mv"], case["cap_h"], case["cap_r"])
    tiles_h = sum(1 for kind, _ in plan.columns if kind == 0)
    path, line = source_anchor(sp.dual_grid, root)
    smem = (gt.per_seg_staging(729, case["c"], 4) if per_seg
            else gt.gather_smem_bytes(729, case["c"], 4))
    name = ("fused_gather_dual_per_seg_kernel" if per_seg
            else "fused_gather_dual_kernel")
    source = sp.KERNEL_PER_SEG if per_seg else sp.KERNEL
    return [LaunchRecord(
        name, name.replace("_kernel", "_f32"), case["case"],
        (plan.grid[0], plan.grid[1], 1), (plan.threads, 1, 1), smem,
        cover=(("hole RIT rows", case["cap_h"], ("block", 0),
                ("const", tiles_h), False),
               ("reference RIT rows", case["cap_r"], ("block", 0),
                ("grid", 0, tiles_h), False)),
        exact=(("MVoxels (grid y)", ("grid", 1), case["num_mv"]),),
        path=path, line=line, counter=source.name)]


def _per_seg(case, root) -> List[LaunchRecord]:
    from repro_torch.kernels import gather_trilerp as gt

    path, line = source_anchor(gt.gather_trilerp_mvoxels_per_seg, root)
    grid_x = -(-case["cap"] // B4_THREADS)  # launch_c's grid, in C
    return [LaunchRecord(
        "gather_trilerp_per_seg_kernel", "gather_trilerp_per_seg_f32",
        case["case"], (grid_x, case["num_mv"], 1), (B4_THREADS, 1, 1),
        gt.per_seg_staging(729, case["c"], 4),
        cover=(("RIT rows of an MVoxel", case["cap"], ("block", 0),
                ("grid", 0), False),),
        exact=(("MVoxels (grid y)", ("grid", 1), case["num_mv"]),),
        path=path, line=line, counter=gt.KERNEL_PER_SEG.name)]


def _mlp(case, root, props, registers) -> List[LaunchRecord]:
    from repro_torch.kernels import fused_nerf_mlp as fm

    s, c, h = case["s"], case["c"], case["h"]
    plan = fm.mlp_plan(c, h, DIR_WIDTH)
    path, line = source_anchor(fm.mlp_plan, root)
    if plan.mode == "tensor":
        regs = registers("fused_nerf_mlp_kernel", (str(plan.width),))
        if regs is None:
            regs = B2_REGS_CAP[plan.width]
        grid = b2_template_grid(s, plan.smem, regs, props)
        return [LaunchRecord(
            "fused_nerf_mlp_kernel", "fused_nerf_mlp_f32", case["case"],
            (grid, 1, 1), (B2_THREADS, 1, 1), plan.smem,
            cover=((f"{B2_TILE_ROWS}-sample warp tiles",
                    -(-s // B2_TILE_ROWS), ("const", B2_THREADS // 32),
                    ("grid", 0), True),),
            path=path, line=line, counter=fm.KERNEL.name)]
    grid = fm.rt_grid(s, plan, props["sms"])  # the wrapper's own grid
    return [LaunchRecord(
        "fused_nerf_mlp_rt_kernel", "fused_nerf_mlp_rt_f32", case["case"],
        (grid, 1, 1), (B2_THREADS, 1, 1), plan.smem,
        cover=((f"{plan.tile}-sample CTA tiles", -(-s // plan.tile),
                ("const", 1), ("grid", 0), True),),
        path=path, line=line, counter=fm.KERNEL.name)]


def _attention(case, root, props) -> List[LaunchRecord]:
    from repro_torch.kernels import flash_attention as fa

    b, h, kvh, sq, sk, d = (case[k] for k in ("b", "h", "kvh", "sq", "sk",
                                              "d"))
    dtype = case["dtype"]
    path, line = source_anchor(fa._launch_kernel, root)
    heads = (("query heads (grid y)", ("grid", 1), h),
             ("batch rows (grid z)", ("grid", 2), b))

    def counter(entry):  # B6 counts its launches by route
        route = next(r for r, es in fa.KERNELS.items() if entry in es)
        return f"{fa.KERNEL.name}.{route}"

    if sq > 1:  # launch_tile / launch_mma: grid (ceil(Sq / BQ), H, B)
        if dtype == "bfloat16":
            kernel, bq, threads, smem = ("flash_mma_kernel", MMA_BQ,
                                         MMA_THREADS, b6_mma_smem(d))
        else:
            kernel, bq, threads, smem = ("flash_tile_kernel", TILE_BQ,
                                         TILE_THREADS, b6_tile_smem(d))
        entry = f"flash_prefill_{_TAG[dtype]}"
        return [LaunchRecord(
            kernel, entry, case["case"], (-(-sq // bq), h, b),
            (threads, 1, 1), smem,
            cover=(("query rows", sq, ("const", bq), ("grid", 0), False),),
            exact=heads, path=path, line=line, counter=counter(entry))]
    splits, split_len = fa.decode_split_plan(sk, b * kvh,
                                             2 * props["sms"])
    chunks = -(-(h // kvh) // DECODE_GMAX)  # launch_split, in C
    entry = f"flash_decode_split_{_TAG[dtype]}"
    split = LaunchRecord(
        "flash_decode_split_kernel", entry, case["case"], (splits, kvh * chunks, b), (d, 1, 1),
        b6_decode_smem(d, dtype),
        cover=(("cache keys", sk, ("const", split_len), ("grid", 0), False),
               ("query heads of a KV head", h // kvh, ("const", DECODE_GMAX),
                ("const", chunks), False)),
        exact=(("KV head chunks (grid y)", ("grid", 1), kvh * chunks),
               ("batch rows (grid z)", ("grid", 2), b),
               ("threads (one per head-dim column)", ("block", 0), d)),
        path=path, line=line, counter=counter(entry))
    entry = f"flash_decode_combine_{_TAG[dtype]}"
    combine = LaunchRecord(  # decode_combine: grid (H, B), D threads
        "flash_decode_combine_kernel", entry, case["case"], (h, b, 1), (d, 1, 1), 0,
        exact=(("query heads (grid x)", ("grid", 0), h),
               ("batch rows (grid y)", ("grid", 1), b),
               ("threads (one per head-dim column)", ("block", 0), d)),
        path=path, line=line, counter=counter(entry))
    return [split, combine]


def plan_launches(props: Optional[Dict[str, int]] = None, root=".",
                  registers: Optional[Callable] = None
                  ) -> List[LaunchRecord]:
    """Every launch of :data:`CASES`, in order, as the plans give it.
    ``props`` are the card's limits (default: the H100's);
    ``registers(kernel, template_args)`` gives a kernel's registers per
    thread where a build log says (B2's template grid depends on them)."""
    props = props or H100
    registers = registers or (lambda kernel, targs: None)
    out: List[LaunchRecord] = []
    for case in CASES:
        kind = case["kind"]
        if kind == "B1":
            out += _gather(case, root)
        elif kind == "B2":
            out += _mlp(case, root, props, registers)
        elif kind in ("B3", "B5"):
            out += _dual(case, root, per_seg=kind == "B5")
        elif kind == "B4":
            out += _per_seg(case, root)
        else:
            out += _attention(case, root, props)
    return out


# ---------------------------------------------------------------------------
# what the card's launches got
# ---------------------------------------------------------------------------


def _demangled_targs(name: str) -> Tuple[str, Tuple[str, ...]]:
    """(kernel, template args) of a trace's demangled kernel name, e.g.
    ``void (anonymous namespace)::gather_trilerp_kernel<float, 4>(...)``
    -> ``("gather_trilerp_kernel", ("float", "4"))``."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    cut = min([s.index(ch) for ch in "<(" if ch in s] + [len(s)])
    base = s[:cut].split("::")[-1].strip()
    if cut == len(s) or s[cut] != "<":
        return base, ()
    depth, end = 0, len(s)
    for i in range(cut, len(s)):
        depth += {"<": 1, ">": -1}.get(s[i], 0)
        if depth == 0:
            end = i
            break
    return base, tuple("bf16" if a.strip() == "__nv_bfloat16" else a.strip()
                       for a in s[cut + 1:end].split(","))


def _mangled_targs(mangled: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """(kernel, template args) of a mangled name in ``ptxas -v``'s log."""
    for base in KERNEL_NAMES:
        tag = f"{len(base)}{base}"
        at = mangled.find(tag)
        if at < 0:
            continue
        pos = at + len(tag)
        if pos >= len(mangled) or mangled[pos] != "I":
            return base, ()
        pos += 1
        args: List[str] = []
        while pos < len(mangled) and mangled[pos] != "E":
            ch = mangled[pos]
            if ch == "L":
                m = re.match(r"L([a-z])(\d+)E", mangled[pos:])
                kind, val = m.group(1), m.group(2)
                args.append(("true" if val == "1" else "false")
                            if kind == "b" else val)
                pos += m.end()
            elif ch.isdigit():
                m = re.match(r"(\d+)", mangled[pos:])
                n = int(m.group(1))
                ident = mangled[pos + m.end():pos + m.end() + n]
                args.append("bf16" if ident == "__nv_bfloat16" else ident)
                pos += m.end() + n
            else:
                args.append({"f": "float", "i": "int", "b": "bool"}.get(
                    ch, ch))
                pos += 1
        return base, tuple(args)
    return None


def ptxas_table(logs: Sequence[Path]) -> Dict[Tuple[str, Tuple[str, ...]],
                                              Dict[str, int]]:
    """``{(kernel, template args): {"registers", "static_smem"}}`` from
    the ``-Xptxas=-v`` build logs."""
    table: Dict[Tuple[str, Tuple[str, ...]], Dict[str, int]] = {}
    for log in logs:
        try:
            lines = Path(log).read_text().splitlines()
        except OSError:
            continue
        key = None
        for line in lines:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                key = _mangled_targs(m.group(1))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and key is not None:
                smem = re.search(r"(\d+) bytes smem", line)
                table[key] = {"registers": int(m.group(1)),
                              "static_smem": int(smem.group(1)) if smem
                              else 0}
                key = None
    return table


def _kernels():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_nerf_mlp as fm
    from repro_torch.kernels import gather_trilerp as gt
    from repro_torch.kernels import streaming_pipeline as sp

    return [gt.KERNEL, gt.KERNEL_PER_SEG, fm.KERNEL, sp.KERNEL,
            sp.KERNEL_PER_SEG, fa.KERNEL]


def card_props(device) -> Dict[str, int]:
    """The card's limits as torch exposes them (the H100's where it does
    not)."""
    import torch

    p = torch.cuda.get_device_properties(device)
    return dict(
        sms=p.multi_processor_count,
        smem_optin=getattr(p, "shared_memory_per_block_optin",
                           SMEM_OPTIN_BYTES),
        smem_per_sm=getattr(p, "shared_memory_per_multiprocessor",
                            H100["smem_per_sm"]),
        regs_per_sm=getattr(p, "regs_per_multiprocessor",
                            H100["regs_per_sm"]),
        threads_per_sm=getattr(p, "max_threads_per_multi_processor",
                               H100["threads_per_sm"]))


def _case_call(case, device, gen) -> Callable[[], Any]:
    """The wrapper call of one case on tensors on the card."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_nerf_mlp as fm
    from repro_torch.kernels import gather_trilerp as gt
    from repro_torch.kernels import streaming_pipeline as sp

    def rand(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=device).to(dtype)

    def ids(rows, cap):
        return torch.randint(0, 729, (rows, cap, 8), generator=gen,
                             device=device, dtype=torch.int32)

    kind = case["kind"]
    if kind == "B1":
        dt = getattr(torch, case["dtype"])
        rows = case["num_seg"] * case["num_mv"]
        t, i, w = (rand(case["num_mv"], 729, case["c"], dtype=dt),
                   ids(rows, case["cap"]), rand(rows, case["cap"], 8))
        return lambda: gt.gather_trilerp_mvoxels_segmented(
            t, i, w, num_seg=case["num_seg"])
    if kind == "B2":
        s, c, h = case["s"], case["c"], case["h"]
        args = [rand(s, c), rand(s, DIR_WIDTH)] + [
            (rand(*shape) - 0.5) * 0.2 for shape in
            ((c, h), (h,), (h, h), (h,), (h, 1), (h + DIR_WIDTH, 3), (3,))]
        return lambda: fm.fused_nerf_mlp(*args)
    if kind in ("B3", "B5"):
        rows = 4 * case["num_mv"] if kind == "B5" else \
            case["num_seg"] * case["num_mv"]
        sets = (ids(rows, case["cap_h"]), rand(rows, case["cap_h"], 8),
                ids(rows, case["cap_r"]), rand(rows, case["cap_r"], 8))
        if kind == "B3":
            t = rand(case["num_mv"], 729, case["c"])
            return lambda: sp.fused_gather_dual(t, *sets,
                                                num_seg=case["num_seg"])
        pages = rand(case["pages"], case["num_mv"], 729, case["c"])
        smap = torch.tensor([0, 1, 0, 2], dtype=torch.int32, device=device)
        return lambda: sp.fused_gather_dual_per_seg(pages, smap, *sets,
                                                    num_seg=4)
    if kind == "B4":
        pages = rand(case["pages"], case["num_mv"], 729, case["c"])
        smap = torch.tensor([0, 1, 0, 2], dtype=torch.int32, device=device)
        rows = 4 * case["num_mv"]
        i, w = ids(rows, case["cap"]), rand(rows, case["cap"], 8)
        return lambda: gt.gather_trilerp_mvoxels_per_seg(pages, smap, i, w,
                                                         num_seg=4)
    dt = getattr(torch, case["dtype"])
    b, h, kvh, sq, sk, d = (case[k] for k in ("b", "h", "kvh", "sq", "sk",
                                              "d"))
    q = rand(b, h, sq, d, dtype=dt) - 0.5
    k, v = rand(b, kvh, sk, d, dtype=dt) - 0.5, rand(b, kvh, sk, d,
                                                     dtype=dt) - 0.5
    kw = dict(causal=case["causal"], kv_len=case.get("kv_len"),
              window=case.get("window", 0), softcap=case.get("softcap", 0.0))
    return lambda: fa.flash_attention(q, k, v, **kw)


def card_plans(device, root=".") -> Tuple[Dict[str, int],
                                          List[LaunchRecord]]:
    """The card's limits and :func:`plan_launches` on them, B2's template
    grids from the registers the build logs report (the kernels are built
    first)."""
    from repro_torch.kernels import _build

    kernels = _kernels()
    _build.build_all(kernels)
    table = ptxas_table([k.log for k in kernels])
    props = card_props(device)
    return props, plan_launches(props, root, lambda kern, targs: table.get(
        (kern, targs), {}).get("registers"))


def recorded_launches(device, root=".",
                      plans: Optional[List[LaunchRecord]] = None
                      ) -> List[LaunchRecord]:
    """Every launch of :data:`CASES`, in order, as the card's trace reports
    it: each wrapper runs once (warm) and once more under
    ``torch.profiler`` with CUDA activity; each of the port's kernel events
    gives its grid, block, shared memory (less the kernel's static shared
    memory from the build log: the dynamic part), registers per thread and
    estimated occupancy. Raises where the trace's launches do not pair
    with the plans' one for one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("recorded_launches reads the card's trace: it "
                         f"needs a CUDA device, got {device}")
    if plans is None:
        plans = card_plans(device, root)[1]
    props = card_props(device)
    table = ptxas_table([k.log for k in _kernels()])
    gen = torch.Generator(device=device).manual_seed(0)
    calls = [_case_call(case, device, gen) for case in CASES]
    with torch.no_grad():
        for call in calls:  # builds, kernel attributes, padded weights
            call()
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for call in calls:
                call()
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    ours = sorted((e for e in events if e.get("cat") == "kernel"
                   and _demangled_targs(e["name"])[0] in KERNEL_NAMES),
                  key=lambda e: e["ts"])
    if len(ours) != len(plans):
        raise RuntimeError(f"recorded_launches: the trace holds {len(ours)} "
                           f"launches of the port's kernels, the plans "
                           f"{len(plans)}")
    out = []
    for plan, ev in zip(plans, ours):
        kernel, targs = _demangled_targs(ev["name"])
        if kernel != plan.kernel:
            raise RuntimeError(f"recorded_launches: {plan.case}: the trace "
                               f"launched {kernel}, the plan {plan.kernel}")
        args = ev["args"]
        static = table.get((kernel, targs), {}).get("static_smem")
        total = int(args["shared memory"])
        regs = int(args["registers per thread"])
        threads = int(np.prod(args["block"]))
        warps = -(-threads // 32)
        resident = occupancy(threads, regs, total, props) * warps
        out.append(dataclasses.replace(
            plan, grid=tuple(int(g) for g in args["grid"]),
            block=tuple(int(t) for t in args["block"]),
            dynamic_smem=total - (static or 0), static_smem=static,
            registers=regs,
            occupancy_pct=float(args.get("est. achieved occupancy %", 0.0)),
            occupancy_model_pct=round(
                100.0 * resident / (props["threads_per_sm"] // 32), 1),
            source="trace"))
    return out


def compare_launches(recorded: Sequence[LaunchRecord],
                     planned: Sequence[LaunchRecord]) -> List[Finding]:
    """A ``kernel-launch-coverage`` finding for each launch whose grid,
    block or dynamic shared memory differs from its plan's: the plan (or
    the Python twin of a C formula) has drifted, and its coverage proof no
    longer holds for what ran."""
    out = []
    for rec, plan in zip(recorded, planned):
        for field in ("grid", "block", "dynamic_smem"):
            got, want = getattr(rec, field), getattr(plan, field)
            if tuple(np.atleast_1d(got)) != tuple(np.atleast_1d(want)):
                out.append(Finding(
                    "kernel-launch-coverage", plan.path, plan.line, 0,
                    f"{plan.kernel} ({plan.case}): the card's launch got "
                    f"{field} {got}, the plan {want}"))
    return out


# ---------------------------------------------------------------------------
# MVoxel layout bank-conflict recompute
# ---------------------------------------------------------------------------

REGISTERED_LAYOUTS = ("identity", "bank_interleaved")
_GATED_LAYOUTS = {"bank_interleaved": 1.0}  # must be conflict-free
_KNOWN_FACTORS = {"identity": 3.0}  # recorded, not gated


def recompute_bank_conflict(layout: str) -> Dict[str, Any]:
    """Independent bank-conflict recompute from the layout's row
    permutation (does NOT call ``streaming.bank_conflict_factor``).

    A trilerp reads the 8 corner rows of one voxel; rows interleave
    across ``num_banks`` banks as ``row % num_banks``. The factor is the
    mean (over every voxel base in the halo block) of the worst bank's
    serialized reads — 1.0 means all 8 corners hit distinct banks.
    """
    from repro_torch.core import streaming

    cfg = streaming.StreamingCfg(layout=layout)
    p, e, b = cfg.mvoxel_edge + 1, cfg.mvoxel_edge, cfg.num_banks
    if layout == "identity":
        row_of = np.arange(p**3, dtype=np.int64)
        padded = p**3
        perm_ok = True
    else:
        rows, padded = streaming.layout_row_map(cfg)
        row_of = rows.astype(np.int64)
        # the map must be a true permutation into [0, padded): every halo
        # point keeps exactly one row, or apply_layout drops features
        perm_ok = (len(np.unique(row_of)) == p**3
                   and row_of.min() >= 0 and row_of.max() < padded)
    # x-major corner ids of every voxel base — recomputed here, not taken
    # from streaming/grids, so a convention drift there is caught
    ax = np.arange(e)
    bx, by, bz = np.meshgrid(ax, ax, ax, indexing="ij")
    base = np.stack([bx, by, bz], -1).reshape(-1, 3)
    offs = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                indexing="ij"), -1).reshape(-1, 3)
    corners = base[:, None, :] + offs[None, :, :]
    ids = (corners[..., 0] * p + corners[..., 1]) * p + corners[..., 2]
    banks = row_of[ids] % b  # [voxels, 8]
    worst = np.stack([np.bincount(row, minlength=b).max() for row in banks])
    return {"layout": layout, "factor": float(worst.mean()),
            "rows": int(padded), "permutation_ok": bool(perm_ok)}


def check_layouts(root=".") -> Tuple[List[Finding], List[Dict[str, Any]]]:
    from repro_torch.core import streaming

    path, line = source_anchor(streaming.layout_row_map, root)
    findings: List[Finding] = []
    stats: List[Dict[str, Any]] = []
    for layout in REGISTERED_LAYOUTS:
        st = recompute_bank_conflict(layout)
        stats.append(st)
        if not st["permutation_ok"]:
            findings.append(Finding(
                "mvoxel-bank-conflict", path, line, 0,
                f"layout '{layout}' row map is not a permutation — "
                "apply_layout would drop or duplicate halo rows"))
        gate = _GATED_LAYOUTS.get(layout)
        if gate is not None and st["factor"] != gate:
            findings.append(Finding(
                "mvoxel-bank-conflict", path, line, 0,
                f"layout '{layout}' bank-conflict factor "
                f"{st['factor']:.3f} != required {gate:.1f} — the 8 "
                "corners of a voxel no longer hit 8 distinct banks"))
    return findings, stats


def run(root, device) -> Tuple[List[Finding], Dict[str, Any]]:
    """The full launch pass: (findings, stats). On the CPU it checks the
    plans; on the card it checks what each launch got and holds it to its
    plan."""
    import torch

    device = torch.device(device)
    findings: List[Finding] = []
    if device.type == "cuda":
        props, planned = card_plans(device, root)
        recorded = recorded_launches(device, root, planned)
        findings += compare_launches(recorded, planned)
        launches = recorded
    else:
        props = H100
        planned = launches = plan_launches(props, root)
        recorded = []
    for rec in launches:
        findings += check_launch(rec, props["smem_optin"])
    layout_findings, layout_stats = check_layouts(root)
    findings += layout_findings
    return findings, {
        "source": "trace" if device.type == "cuda" else "plan",
        # launches held to their plans' grid, block and dynamic shared
        # memory (a mismatch is a kernel-launch-coverage finding)
        "held_to_plan": len(recorded),
        "launches": [r.row() for r in launches],
        "planned": [r.row() for r in planned],
        "layouts": layout_stats}
