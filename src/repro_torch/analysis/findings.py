"""Findings, inline suppressions, and report formatting for
``repro_torch.analysis`` (the twin of ``repro.analysis.findings``).

Every pass (AST lint, tick program, kernel launch) emits :class:`Finding`
records anchored to a ``path:line:col``. A finding is *suppressed* when the
anchored source line — or the line immediately above it — carries an
inline marker::

    some_offending_call()  # lint: disable=rule-id -- why this is intentional

The justification after ``--`` is mandatory: a bare ``disable`` marker does
NOT suppress (an unjustified suppression keeps its finding, so the clean
baseline stays honest).
"""
from __future__ import annotations

import dataclasses
import inspect
import re
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=(?P<rules>[A-Za-z0-9_,-]+)"
    r"(?:\s*--\s*(?P<why>\S.*))?")


def relpath(path: str, root) -> str:
    """``path`` relative to ``root`` (as posix), or as it is outside it."""
    try:
        return Path(path).resolve().relative_to(
            Path(root).resolve()).as_posix()
    except ValueError:
        return path


def source_anchor(fn: Callable, root) -> Tuple[str, int]:
    """(repo-relative path, line) where ``fn`` is defined: the anchor of a
    finding about what ``fn`` computes."""
    raw = inspect.unwrap(fn)
    return (relpath(inspect.getsourcefile(raw) or "<unknown>", root),
            inspect.getsourcelines(raw)[1])


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation anchored to a source location."""

    rule: str          # stable rule id, e.g. "graph-host-sync"
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str
    suppressed: bool = False
    justification: str = ""

    def format(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col} {self.rule}{tag} — {self.message}"


def _suppression_for(lines: Sequence[str], line: int, rule: str
                     ) -> Optional[str]:
    """Return the justification if ``rule`` is disabled at ``line``
    (same line or the immediately preceding one); None otherwise."""
    for ln in (line, line - 1):
        if 1 <= ln <= len(lines):
            m = _SUPPRESS_RE.search(lines[ln - 1])
            if m and rule in m.group("rules").split(","):
                return m.group("why") or ""
    return None


def apply_suppressions(findings: Iterable[Finding], root: Path
                       ) -> List[Finding]:
    """Mark findings whose anchor line carries a justified inline
    ``# lint: disable=<rule> -- <why>`` marker as suppressed. Unjustified
    markers do not suppress."""
    out: List[Finding] = []
    cache: Dict[str, List[str]] = {}
    for f in findings:
        lines = cache.get(f.path)
        if lines is None:
            try:
                lines = (root / f.path).read_text().splitlines()
            except OSError:
                lines = []
            cache[f.path] = lines
        why = _suppression_for(lines, f.line, f.rule)
        if why:  # empty-string justification == unjustified == not suppressed
            f = dataclasses.replace(f, suppressed=True, justification=why)
        out.append(f)
    return out


@dataclasses.dataclass
class Report:
    """Aggregated run result across all passes."""

    findings: List[Finding]
    rules_run: List[str]

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    def summary(self) -> Dict[str, object]:
        per_rule = Counter(f.rule for f in self.active)
        return {
            "rules": len(self.rules_run),
            "findings": len(self.active),
            "suppressed": len(self.suppressed),
            "per_rule": dict(sorted(per_rule.items())),
        }

    def format(self) -> str:
        lines = []
        for f in sorted(self.findings, key=lambda f: (f.path, f.line, f.col)):
            lines.append(f.format())
        s = self.summary()
        lines.append(
            f"repro_torch.analysis: {s['rules']} rules, {s['findings']} "
            f"findings, {s['suppressed']} suppressed")
        return "\n".join(lines)
