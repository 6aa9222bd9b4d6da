"""accord-lint: whole-repo protocol static analysis.

One shared AST/call-graph index (`core.RepoIndex`) feeds five passes:

===========  ==========================================================
blocking     event-loop blocking-call detector (reachability from the
             selector-loop roots and Node._process to time.sleep,
             Condition.wait, fsync, blocking sockets, subprocess)
determinism  sim-determinism lint (wall clocks, module-global random,
             id() keys, set iteration, env reads outside config load
             in the sim import closure)
threads      cross-thread shared-state audit (attributes mutated from
             ≥2 thread contexts without a recognized lock or the
             wakeup-socketpair marshalling idiom)
surface      registry/exhaustiveness (verb claims, EVENT_KINDS,
             Node rx/tx instrumentation, wire._MODULES coverage,
             native-vs-Python export parity)
layering     import boundaries (obs/ and analysis/ stay off jax)
===========  ==========================================================

Run `python -m accord_tpu_torch.analysis` (see `--help`); the checked-in
baseline (`baseline.json`) suppresses accepted findings, each with a
one-line justification.  Tier-1 keeps the suite clean via
tests/test_analysis.py::test_repo_is_clean.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from . import blocking, determinism, layering, surface, threads
from .baseline import DEFAULT_BASELINE, apply_baseline, load_baseline
from .core import RepoIndex, build_package_index
from .findings import Finding

PASSES: Dict[str, Callable[[RepoIndex], List[Finding]]] = {
    "blocking": blocking.run,
    "determinism": determinism.run,
    "threads": threads.run,
    "surface": surface.run,
    "layering": layering.run,
}


@dataclass
class RunReport:
    new: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stale: List[str] = field(default_factory=list)
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.new


def run_passes(index: RepoIndex,
               select: Optional[Sequence[str]] = None,
               ) -> Dict[str, List[Finding]]:
    out: Dict[str, List[Finding]] = {}
    for name in (select or PASSES):
        if name not in PASSES:
            raise KeyError(f"unknown pass {name!r}; have {sorted(PASSES)}")
        out[name] = PASSES[name](index)
    return out


def run_repo(select: Optional[Sequence[str]] = None,
             baseline_path: Optional[Path] = DEFAULT_BASELINE,
             index: Optional[RepoIndex] = None) -> RunReport:
    """Run the suite over the installed package against the baseline."""
    report = RunReport()
    t0 = time.perf_counter()
    if index is None:
        index = build_package_index()
    report.timings["index"] = time.perf_counter() - t0
    findings: List[Finding] = []
    for name in (select or PASSES):
        t0 = time.perf_counter()
        findings.extend(run_passes(index, [name])[name])
        report.timings[name] = time.perf_counter() - t0
    baseline = load_baseline(baseline_path) if baseline_path else {}
    report.new, report.suppressed, stale = apply_baseline(findings, baseline)
    # a baseline entry for a deselected pass is not stale — it just didn't run
    ran = set(select or PASSES)
    report.stale = [k for k in stale if k.split("::", 1)[0] in ran]
    return report
