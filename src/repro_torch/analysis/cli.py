"""CLI driver for the port's three-pass static checker.

``python -m repro_torch.analysis`` runs the AST lint, the tick-program pass
and the kernel-launch pass over the port, applies inline suppressions,
prints the findings report and exits nonzero on any unsuppressed finding.
``--json`` also writes the ``{rules, findings, suppressed, per_rule,
passes, seconds, steady_tick_transfer_free, ...}`` summary.

The AST pass needs no device. The program and launch passes run on the
CUDA card (where the tick programs launch the kernels and the launch pass
reads each launch's geometry off the card) unless the caller passes
``--device cpu`` (the plain versions run, and the launches are the plans');
without a card and without ``--device cpu`` they raise.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis import astlint
from repro_torch.analysis.findings import Finding, Report, apply_suppressions

PASSES = ("ast", "program", "launch")
# the port's files the AST pass scans (repo-relative globs); the
# reference's files belong to repro.analysis, whose JAX rules they follow
SCAN_GLOBS = ("src/repro_torch/**/*.py", "chip_smoke.py",
              "tests/test_torch_*.py", "tests/torch_ranks.py",
              "scripts/gloo_cuda_probe.py", "scripts/lm_noise_floor.py",
              "scripts/lm_serve_bench.py", "scripts/steady_tick_bench.py")


def repo_root(start: Optional[Path] = None) -> Path:
    p = (start or Path.cwd()).resolve()
    for cand in (p, *p.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return p


def python_files(root: Path) -> List[str]:
    rels = set()
    for pattern in SCAN_GLOBS:
        rels.update(p.relative_to(root).as_posix()
                    for p in root.glob(pattern) if p.is_file())
    return sorted(rels)


def run_repo_analysis(root: Path, passes: Sequence[str] = PASSES,
                      device=None):
    """Run the selected passes; returns (Report, stats dict). ``device``
    (the program and launch passes') defaults to the CUDA card and must be
    given as "cpu" where there is none."""
    findings: List[Finding] = []
    rules: List[str] = []
    stats: Dict[str, Any] = {}
    t0 = time.perf_counter()
    if "program" in passes or "launch" in passes:
        from repro_torch.utils import resolve_device

        device = resolve_device(device)
    clock: Dict[str, float] = {}
    if "ast" in passes:
        t = time.perf_counter()
        files = python_files(root)
        findings.extend(astlint.lint_paths(root, files))
        rules.extend(astlint.ALL_RULES)
        stats["ast"] = {"files": len(files)}
        clock["ast"] = time.perf_counter() - t
    if "program" in passes:
        from repro_torch.analysis import program_pass

        t = time.perf_counter()
        fs, st = program_pass.run(root, device)
        findings.extend(fs)
        rules.extend(program_pass.ALL_RULES)
        stats["program"] = st
        clock["program"] = time.perf_counter() - t
    if "launch" in passes:
        from repro_torch.analysis import launch_pass

        t = time.perf_counter()
        fs, st = launch_pass.run(root, device)
        findings.extend(fs)
        rules.extend(launch_pass.ALL_RULES)
        stats["launch"] = st
        clock["launch"] = time.perf_counter() - t
    findings = apply_suppressions(findings, root)
    stats["seconds"] = round(time.perf_counter() - t0, 2)
    stats["pass_seconds"] = {p: round(t, 2) for p, t in clock.items()}
    return Report(findings=findings, rules_run=rules), stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static invariant checker of the port: AST lint + "
                    "tick-program pass + kernel-launch pass")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--json", type=Path, default=None,
                    help="write the summary dict to this path")
    ap.add_argument("--skip-pass", action="append", default=[],
                    choices=list(PASSES), help="skip a pass (repeatable)")
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"],
                    help="device of the program and launch passes "
                         "(default: the CUDA card, which must exist)")
    args = ap.parse_args(argv)
    root = repo_root(args.root)
    passes = tuple(p for p in PASSES if p not in args.skip_pass)
    report, stats = run_repo_analysis(root, passes, args.device)
    print(report.format())
    summary = report.summary()
    summary["passes"] = list(passes)
    summary["seconds"] = stats["seconds"]
    summary["pass_seconds"] = stats["pass_seconds"]
    if "program" in stats:
        summary["steady_tick_transfer_free"] = (
            stats["program"].get("steady_tick_transfer_free"))
        summary["device"] = stats["program"]["device"]
    for name in ("program", "launch"):
        if name in stats:
            summary[name] = stats[name]
    if args.json:
        args.json.write_text(json.dumps(summary, indent=2, sort_keys=True))
    return 1 if report.active else 0


if __name__ == "__main__":
    sys.exit(main())
