"""Baseline handling for accord-lint.

The baseline file (`accord_tpu_torch/analysis/baseline.json`) is the list of
findings the repo has consciously accepted.  Policy: **every entry must
carry a one-line justification** — an entry with a missing, empty or
"TODO"-prefixed justification fails loading, so `--write-baseline`
output (which stamps `TODO: justify`) cannot be checked in unedited.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from .findings import Finding

DEFAULT_BASELINE = Path(__file__).parent / "baseline.json"


class BaselineError(ValueError):
    pass


def load_baseline(path: Path = DEFAULT_BASELINE) -> Dict[str, str]:
    """Map of finding key -> justification; validates the policy."""
    if not Path(path).exists():
        return {}
    data = json.loads(Path(path).read_text())
    entries = data.get("entries", [])
    out: Dict[str, str] = {}
    for e in entries:
        key = e.get("key")
        just = (e.get("justification") or "").strip()
        if not key:
            raise BaselineError(f"baseline entry missing key: {e!r}")
        if not just or just.upper().startswith("TODO"):
            raise BaselineError(
                f"baseline entry for {key!r} has no justification — every "
                f"suppressed finding needs a one-line reason")
        if key in out:
            raise BaselineError(f"duplicate baseline key: {key!r}")
        out[key] = just
    return out


def apply_baseline(findings: List[Finding], baseline: Dict[str, str],
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split findings into (new, suppressed) and report stale keys."""
    new: List[Finding] = []
    suppressed: List[Finding] = []
    seen: set = set()
    for f in findings:
        if f.key in baseline:
            suppressed.append(f)
            seen.add(f.key)
        else:
            new.append(f)
    stale = [k for k in baseline if k not in seen]
    return new, suppressed, stale


def write_baseline(findings: Iterable[Finding], path: Path,
                   justifications: Dict[str, str] = None) -> None:
    """Write a baseline template; unjustified entries get `TODO: justify`
    which the loader rejects, forcing a human-written reason per entry."""
    justifications = justifications or {}
    entries = []
    seen = set()
    for f in sorted(findings, key=lambda f: f.key):
        if f.key in seen:
            continue
        seen.add(f.key)
        entries.append({
            "key": f.key,
            "finding": f.render(),
            "justification": justifications.get(f.key, "TODO: justify"),
        })
    Path(path).write_text(json.dumps({"entries": entries}, indent=2) + "\n")
