"""Tick-program instrumentation: count new programs and CUDA-graph captures
across a stretch of work (the twin of ``repro.analysis.jitprobe``).

``GraphProbe`` snapshots an engine's ``len(tick_programs)`` (one program
per key ``(path, S, N, bucket, bucket_coarse)``, the reference's compile
targets) and ``num_captures`` (the programs captured into a CUDA graph)
and reports the delta. The serving engine's contract is a steady-state
delta of zero: after warmup, ticks replay the programs they have (new
programs only on admission shape changes, bounded by the pool ladder).
"""
from __future__ import annotations

import contextlib
from typing import Dict


def _sizes(engine) -> Dict[str, int]:
    return {"tick_programs": len(engine.tick_programs),
            "captures": engine.num_captures}


class GraphProbe:
    """New-program counter over an engine's tick programs.

    >>> probe = GraphProbe(engine)
    >>> ... serving work ...
    >>> probe.new_programs()   # programs made since construction
    """

    def __init__(self, engine):
        self.engine = engine
        self.baseline = _sizes(engine)

    def reset(self) -> None:
        self.baseline = _sizes(self.engine)

    def delta(self) -> Dict[str, int]:
        now = _sizes(self.engine)
        return {k: now[k] - self.baseline[k] for k in now}

    def new_programs(self) -> int:
        """New tick programs and new captures since the baseline."""
        return sum(max(0, d) for d in self.delta().values())

    @contextlib.contextmanager
    def assert_no_new_programs(self, what: str = "steady state"):
        """Context manager asserting the wrapped work made NO tick program
        and captured no graph: re-steering a program's inputs (poses, the
        scene map, page contents) must never make another."""
        self.reset()
        yield self
        if self.new_programs() != 0:
            raise AssertionError(
                f"{what} made new tick programs: {self.delta()} (expected "
                f"no new program and no new capture from "
                f"{self.baseline})")
