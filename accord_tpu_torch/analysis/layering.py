"""Layering pass: import-boundary guards.

- ``accord_tpu_torch.obs`` must stay off the device path: no ``jax`` /
  ``jaxlib`` / ``numpy`` / ``torch`` imports (the port's device stack is
  torch), and its only intra-repo imports are
  ``accord_tpu_torch.obs.*`` (anything else risks transitively pulling jax
  onto the always-on observability path).  This is the structural half
  of the determinism pass's obs carve-out: obs may read real clocks
  precisely because nothing in the protocol can import it back.
- ``accord_tpu_torch.analysis`` itself obeys the same no-jax, no-torch
  rule (the linter must run on a box with no device stack at all).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from .core import RepoIndex
from .findings import Finding

PASS_ID = "layering"

BANNED_ROOTS = ("jax", "jaxlib", "numpy", "torch")

# (package prefix, intra-repo import allowance or None for "any")
GUARDED: Tuple[Tuple[str, str], ...] = (
    ("obs", "obs"),
    ("analysis", None),
)


def run(index: RepoIndex) -> List[Finding]:
    pkg = index.package
    findings: List[Finding] = []
    for sub, allowance in GUARDED:
        prefix = f"{pkg}.{sub}"
        for mod in index.modules.values():
            if not (mod.name == prefix or mod.name.startswith(prefix + ".")):
                continue
            rel = index.relpath(mod.path)
            for target in sorted(mod.import_targets):
                root = target.split(".")[0]
                if root in BANNED_ROOTS:
                    findings.append(Finding(
                        pass_id=PASS_ID, file=rel, line=1,
                        qualname=mod.name, code="device-import",
                        message=f"{mod.name} imports {target}: {sub}/ must "
                                f"stay off the device path",
                        detail=target))
                elif root == pkg and allowance is not None:
                    allowed = f"{pkg}.{allowance}"
                    if not (target == allowed
                            or target.startswith(allowed + ".")):
                        findings.append(Finding(
                            pass_id=PASS_ID, file=rel, line=1,
                            qualname=mod.name, code="layer-import",
                            message=f"{mod.name} imports {target}: {sub}/ "
                                    f"may only import within {allowed} "
                                    f"(anything else risks pulling jax in)",
                            detail=target))
    return findings
