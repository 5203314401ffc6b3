"""Roofline terms of one rank's step on an NVIDIA H100 (port of
``repro.roofline.analysis``).

  compute_s    = FLOPs a rank runs / PEAK_FLOPS_BF16
  memory_s     = the analytic HBM bytes (else the counted bytes) / HBM_BW
  collective_s = a rank's ring-weighted collective bytes / LINK_BW

The numbers are a rank's, from :mod:`repro_torch.roofline.cost`, which
counts them op by op as the program runs (the reference parses them from
its compiled SPMD module's HLO). So ``FLOPs(global) = FLOPs a rank x
ranks``, as in the reference.

The constants are the card's, from NVIDIA's H100 SXM5 datasheet (the
card ``nvidia-smi`` names ``NVIDIA H100 80GB HBM3``, power limit 700.00
W): dense BF16 tensor-core peak 989.4 TFLOP/s, HBM3 3.35 TB/s. For
``collective_s`` one link per direction: the inter-node port, one
ConnectX-7 NDR InfiniBand link of 400 Gb/s = 50 GB/s per GPU, because
every 16-wide axis of the production meshes spans two 8-GPU HGX nodes,
so it is the slowest link each ring crosses. Inside a node NVLink 4
carries 450 GB/s per direction (:data:`NVLINK_BW`, not used by the
terms).

``coll_bf16wire_bytes`` keeps the reference's definition, the weighted
collective bytes with their float32 share halved. It is a counterfactual
(what the wire would carry were every float32 collective sent in
bfloat16), not what NCCL carries. The reference's ``collective_bytes``
and ``cost_analysis_dict`` parse XLA's HLO and compiled cost analysis,
which a PyTorch program has no twin of, so the port has neither;
:func:`from_counts` takes the place of its ``from_compiled``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Mapping

# --- NVIDIA H100 SXM5 (per GPU), NVIDIA's datasheet ---
PEAK_FLOPS_BF16 = 989.4e12  # dense BF16 tensor-core FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
LINK_BW = 50e9  # one ConnectX-7 NDR 400 Gb/s link, bytes/s per direction
NVLINK_BW = 450e9  # NVLink 4 within a node, bytes/s per direction


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    num_devices: int
    # per-rank counts
    flops: float
    bytes_accessed: float  # the counted bytes (every op's operands + result)
    coll_weighted_bytes: float
    coll_by_op: Dict[str, float]
    coll_counts: Dict[str, int]
    # memory (per rank)
    arg_bytes: int = 0
    temp_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    # analytic HBM traffic (the memory term's source; see analytic_hbm_bytes)
    hbm_bytes: float = 0.0
    coll_bf16wire_bytes: float = 0.0  # the counterfactual bf16 wire
    # model accounting
    model_flops_global: float = 0.0
    notes: str = ""

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        src = self.hbm_bytes if self.hbm_bytes > 0 else self.bytes_accessed
        return src / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_weighted_bytes / LINK_BW

    @property
    def collective_bf16wire_s(self) -> float:
        src = self.coll_bf16wire_bytes or self.coll_weighted_bytes
        return src / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The roofline step: the largest of the three terms (perfect
        overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / FLOPs(global): the remat and redundancy meter."""
        total = self.flops * self.num_devices
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_time_s * PEAK_FLOPS_BF16 * self.num_devices
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s,
                 collective_bf16wire_s=self.collective_bf16wire_s,
                 dominant=self.dominant,
                 step_time_s=self.step_time_s, mfu=self.mfu,
                 useful_flops_fraction=self.useful_flops_fraction)
        return d


def analytic_hbm_bytes(cfg, shape, mesh_axis_sizes: Dict[str, int],
                       arg_bytes: float, out_bytes: float,
                       alias_bytes: float = 0.0) -> float:
    """A rank's HBM traffic for the memory term, in closed form (the
    reference's model, value for value):
      train:   read and write every arg (params, moments; aliased) + the
               activation carries read and written (Megatron-SP sharded) +
               the logits chunks (forward and backward)
      prefill: read the args + write the caches + the carries
      decode:  read the args (params + the whole KV cache) + write the
               logits and the new slot
    """
    tp = mesh_axis_sizes.get("model", 1)
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh_axis_sizes.get(a, 1)
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    b_loc = max(shape.global_batch // dp, 1)
    if shape.kind == "train":
        carry = b_loc * shape.seq_len * cfg.d_model * dtype_bytes / tp
        carries = 2.0 * carry * cfg.num_periods
        logits = 2.0 * b_loc * shape.seq_len * (cfg.vocab_size / tp) * 4.0
        return 2.0 * arg_bytes + carries + logits
    if shape.kind == "prefill":
        carry = b_loc * shape.seq_len * cfg.d_model * dtype_bytes / tp
        return arg_bytes + out_bytes + 2.0 * carry * cfg.num_periods
    # decode: read the weights and the whole KV cache; the aliased cache
    # writes are in place (one slot), so only the output not aliased counts
    return arg_bytes + max(out_bytes - alias_bytes, 0.0)


def model_flops(cfg, shape) -> float:
    """6 N_active tokens (train) or 2 N_active tokens (inference),
    global."""
    n = cfg.active_param_count()
    toks = shape.tokens_per_step
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * toks


def from_counts(arch: str, shape_name: str, mesh_name: str,
                num_devices: int, counts: Mapping[str, object],
                memory: Mapping[str, int], model_flops_global: float = 0.0,
                notes: str = "") -> RooflineReport:
    """The report of one rank: ``counts`` from
    :func:`repro_torch.roofline.cost.analyze` (the whole step executed:
    an eager loop runs every trip, so no trip correction is needed) and
    ``memory``'s ``arg_bytes`` / ``output_bytes`` / ``alias_bytes`` /
    ``temp_bytes`` (the dry-run's bytes of the rank's blocks)."""
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, num_devices=num_devices,
        flops=float(counts["flops"]), bytes_accessed=float(counts["bytes"]),
        coll_weighted_bytes=float(counts["weighted_coll_bytes"]),
        coll_bf16wire_bytes=float(counts["weighted_coll_bytes_bf16wire"]),
        coll_by_op=dict(counts["coll_by_op"]),
        coll_counts=dict(counts["coll_counts"]),
        arg_bytes=int(memory.get("arg_bytes", 0)),
        temp_bytes=int(memory.get("temp_bytes", 0)),
        output_bytes=int(memory.get("output_bytes", 0)),
        alias_bytes=int(memory.get("alias_bytes", 0)),
        model_flops_global=model_flops_global, notes=notes)
