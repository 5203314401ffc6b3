"""repro_torch.analysis — the port's static invariant checker (the twin of
``repro.analysis``).

Three passes over the port (see README.md for the rule catalog):

1. **AST lint** (:mod:`repro_torch.analysis.astlint`) — stdlib-``ast``
   rules for host reads in captured bodies (tick programs, CUDA-graph
   captures), tick-program keys, raw ``hash()`` seeding, mutable
   frozen-dataclass defaults and kernel launches without a plain route.
2. **program** (:mod:`repro_torch.analysis.program_pass`) — runs the real
   tick program bodies of a tiny engine under an op recorder and proves
   them transfer-free, static-shaped and fingerprint-covered.
3. **launch** (:mod:`repro_torch.analysis.launch_pass`) — plans every
   kernel's launch geometry at the arms' shapes (on the card: reads what
   each launch got off the profiler's trace) and checks coverage, shared
   memory and the MVoxel bank layout.

Run with ``python -m repro_torch.analysis`` (the card) or ``python -m
repro_torch.analysis --device cpu``.
"""
from repro_torch.analysis.cli import main, run_repo_analysis  # noqa: F401
from repro_torch.analysis.findings import Finding, Report  # noqa: F401
from repro_torch.analysis.graphprobe import GraphProbe  # noqa: F401
