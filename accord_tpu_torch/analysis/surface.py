"""Registry / exhaustiveness pass.

Folds the repo's coverage lints onto the shared index and adds the
native-tier parity check:

- every ``*_REQ``/``*_MSG`` verb in the MessageType registry is claimed
  by a message class under ``messages/`` (``COLLAPSED_VERBS`` allowlist
  for the deliberately-collapsed Propagate tiers, which must not rot);
- every flight-recorder kind recorded anywhere is documented in
  ``obs.flight.EVENT_KINDS`` and vice versa, with a real description;
- ``Node._process`` / ``Node.send`` keep the generic ``rx`` span +
  flight ``rx``/``tx`` instrumentation every claimed verb flows through;
- every module under ``messages/`` is listed in ``host.wire._MODULES``
  (a forgotten module means its payloads cannot cross the wire);
- native-vs-Python export parity: names exported by each C extension's
  ``PyMethodDef`` table match the attributes its Python callers actually
  use — a missing export breaks the native tier at runtime, a dead
  export is an unpinned code path.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .core import RepoIndex
from .findings import Finding

PASS_ID = "surface"

# The port deliberately applies every Propagate tier through ONE local
# request class typed PROPAGATE_OTHER_MSG (messages/propagate.py); the
# per-tier verbs stay in the registry for reference parity but are never
# emitted.  Any OTHER unclaimed verb is a finding.
COLLAPSED_VERBS = frozenset({
    "PROPAGATE_PRE_ACCEPT_MSG", "PROPAGATE_STABLE_MSG",
    "PROPAGATE_APPLY_MSG",
})

# getter in native/__init__ -> C source whose PyMethodDef it loads
NATIVE_GETTERS = {
    "get": "_sorted_arrays.cpp",
    "get_wire": "_wire_codec.cpp",
    "get_cfk": "_cfk_core.cpp",
}


# ------------------------------------------------------------------ verbs --
def claimed_verbs(index: RepoIndex, enum_name: str = "MessageType",
                  messages_pkg: Optional[str] = None,
                  ) -> Dict[str, List[str]]:
    """{verb: [basenames]} for every assignment referencing
    `<enum_name>.X` under the messages package (excluding the registry
    module itself)."""
    messages_pkg = messages_pkg or f"{index.package}.messages"
    out: Dict[str, List[str]] = {}
    for mod in index.modules.values():
        if not mod.name.startswith(messages_pkg):
            continue
        if mod.path.name == "base.py":
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            for v in ([node.value] if node.value is not None else []):
                if isinstance(v, ast.Attribute) \
                        and isinstance(v.value, ast.Name) \
                        and v.value.id == enum_name:
                    out.setdefault(v.attr, []).append(mod.path.name)
    return out


def _enum_member_lines(index: RepoIndex, enum_name: str,
                       ) -> Tuple[Optional[str], Dict[str, int]]:
    """(relpath, {member: lineno}) of the AST class named `enum_name`."""
    for cls in index.classes.values():
        if cls.name != enum_name:
            continue
        lines: Dict[str, int] = {}
        for node in cls.node.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        lines[t.id] = node.lineno
        return index.relpath(index.modules[cls.module].path), lines
    return None, {}


def verb_findings(index: RepoIndex, verbs: Optional[Iterable[str]] = None,
                  collapsed: frozenset = COLLAPSED_VERBS,
                  enum_name: str = "MessageType",
                  messages_pkg: Optional[str] = None) -> List[Finding]:
    enum_file, member_lines = _enum_member_lines(index, enum_name)
    if verbs is None:
        verbs = list(member_lines)
    claimed = claimed_verbs(index, enum_name, messages_pkg)
    findings: List[Finding] = []
    file = enum_file or index.package
    for v in verbs:
        if not (v.endswith("_REQ") or v.endswith("_MSG")):
            continue     # replies correlate via msg ids, not dispatch
        if v in claimed or v in collapsed:
            continue
        findings.append(Finding(
            pass_id=PASS_ID, file=file, line=member_lines.get(v, 1),
            qualname=f"{enum_name}.{v}", code="verb-unclaimed",
            message=f"verb {v} registered in {enum_name} but claimed by no "
                    f"message class — it can never be processed or traced "
                    f"as rx:{v}", detail=v))
    known = set(verbs)
    for v, files in sorted(claimed.items()):
        if v not in known:
            findings.append(Finding(
                pass_id=PASS_ID, file=file, line=member_lines.get(v, 1),
                qualname=f"{enum_name}.{v}", code="verb-unknown",
                message=f"{files} claim verb {v} which {enum_name} does "
                        f"not register", detail=v))
    for v in sorted(collapsed):
        if v in claimed:
            findings.append(Finding(
                pass_id=PASS_ID, file=file, line=member_lines.get(v, 1),
                qualname=f"{enum_name}.{v}", code="verb-allowlist-stale",
                message=f"verb {v} is in COLLAPSED_VERBS but now claimed — "
                        f"drop it from the allowlist", detail=v))
    return findings


# ----------------------------------------------------------- flight kinds --
def recorded_flight_kinds(index: RepoIndex) -> Dict[str, List[str]]:
    """{kind: [paths relative to the package root]} for every literal
    kind passed to a `.record("<kind>", ...)` call."""
    kinds: Dict[str, List[str]] = {}
    for mod in index.modules.values():
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "record" and n.args \
                    and isinstance(n.args[0], ast.Constant) \
                    and isinstance(n.args[0].value, str):
                kinds.setdefault(n.args[0].value, []).append(
                    str(mod.path.relative_to(index.root)))
    return kinds


def flight_findings(index: RepoIndex, event_kinds: Dict[str, str],
                    flight_file: str = "obs/flight.py") -> List[Finding]:
    recorded = recorded_flight_kinds(index)
    findings: List[Finding] = []
    file = str(Path(index.package) / flight_file)
    for kind, files in sorted(recorded.items()):
        if kind not in event_kinds:
            findings.append(Finding(
                pass_id=PASS_ID, file=file, line=1, qualname=kind,
                code="flight-undocumented",
                message=f"flight kind {kind!r} recorded in {files} but not "
                        f"documented in EVENT_KINDS", detail=kind))
    for kind, desc in event_kinds.items():
        if kind not in recorded:
            findings.append(Finding(
                pass_id=PASS_ID, file=file, line=1, qualname=kind,
                code="flight-dead",
                message=f"EVENT_KINDS documents {kind!r} which nothing "
                        f"records", detail=kind))
        if not (len(desc) > 20 and "/" in desc):
            findings.append(Finding(
                pass_id=PASS_ID, file=file, line=1, qualname=kind,
                code="flight-desc",
                message=f"EVENT_KINDS[{kind!r}] description must name its "
                        f"emitting layer (len>20 with a path)", detail=kind))
    return findings


# -------------------------------------------------- node instrumentation --
def instrumentation_findings(index: RepoIndex) -> List[Finding]:
    """Node._process keeps the generic rx span + flight rx record and
    Node.send the tx record — every claimed verb flows through these."""
    findings: List[Finding] = []
    node_mod = f"{index.package}.local.node"

    def check(fq: str, attr: str, literal: Optional[str], what: str) -> None:
        fn = index.functions.get(fq)
        if fn is None:
            findings.append(Finding(
                pass_id=PASS_ID, file=f"{index.package}/local/node.py",
                line=1, qualname=fq, code="node-instrumentation",
                message=f"{fq} missing", detail=what))
            return
        for n in ast.walk(fn.node):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == attr:
                if literal is None:
                    return
                if n.args and isinstance(n.args[0], ast.Constant) \
                        and n.args[0].value == literal:
                    return
        findings.append(Finding(
            pass_id=PASS_ID, file=index.relpath(fn.path), line=fn.lineno,
            qualname=fq, code="node-instrumentation",
            message=f"{fq.split('::')[-1]} lost the {what}", detail=what))

    check(f"{node_mod}::Node._process", "rx", None, "obs.rx span event")
    check(f"{node_mod}::Node._process", "record", "rx", "flight 'rx' record")
    check(f"{node_mod}::Node.send", "record", "tx", "flight 'tx' record")
    return findings


# -------------------------------------------------------- wire registry --
def wire_module_findings(index: RepoIndex, registered: Sequence[str],
                         ) -> List[Finding]:
    findings: List[Finding] = []
    prefix = f"{index.package}.messages."
    for mod in sorted(index.modules.values(), key=lambda m: m.name):
        if not mod.name.startswith(prefix) or mod.is_package:
            continue
        if mod.name not in registered:
            findings.append(Finding(
                pass_id=PASS_ID, file=index.relpath(mod.path), line=1,
                qualname=mod.name, code="wire-unregistered-module",
                message=f"{mod.name} is not in host.wire._MODULES — its "
                        f"classes cannot cross the wire", detail=mod.name))
    return findings


# --------------------------------------------------------- native parity --
_METHODDEF_RE = re.compile(r'\{\s*"(\w+)"\s*,')

def _cpp_exports(cpp_path: Path) -> Dict[str, int]:
    """{exported name: lineno} from the PyMethodDef table in a C source."""
    out: Dict[str, int] = {}
    in_table = False
    for i, line in enumerate(cpp_path.read_text().splitlines(), 1):
        if "PyMethodDef" in line:
            in_table = True
        if in_table:
            m = _METHODDEF_RE.search(line)
            if m:
                out[m.group(1)] = i
            if "};" in line.replace(" ", ""):
                in_table = False
    return out


def _native_handle_uses(index: RepoIndex) -> Dict[str, Dict[str, Tuple[str, int]]]:
    """getter -> {attr: (relpath, lineno)} for attributes accessed on
    variables bound from accord_tpu_torch.native.get/get_wire/get_cfk()."""
    uses: Dict[str, Dict[str, Tuple[str, int]]] = {g: {} for g in NATIVE_GETTERS}
    native_mod = f"{index.package}.native"
    for mod in index.modules.values():
        if mod.name.startswith(native_mod):
            continue
        handles: Dict[str, str] = {}   # var name -> getter
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and isinstance(n.value, ast.Call):
                dotted = index.dotted_of(mod, n.value.func)
                if dotted and dotted.startswith(native_mod + "."):
                    getter = dotted.rsplit(".", 1)[1]
                    if getter in NATIVE_GETTERS:
                        handles[n.targets[0].id] = getter
        if not handles:
            continue
        rel = index.relpath(mod.path)
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) \
                    and n.value.id in handles:
                uses[handles[n.value.id]].setdefault(
                    n.attr, (rel, n.lineno))
    return uses


def native_parity_findings(index: RepoIndex) -> List[Finding]:
    findings: List[Finding] = []
    native_dir = index.root / "native"
    if not native_dir.exists():
        return findings
    uses = _native_handle_uses(index)
    for getter, cpp_name in NATIVE_GETTERS.items():
        cpp = native_dir / cpp_name
        if not cpp.exists():
            continue
        exports = _cpp_exports(cpp)
        cpp_rel = str(Path(index.package) / "native" / cpp_name)
        for attr, (rel, lineno) in sorted(uses[getter].items()):
            if attr not in exports:
                findings.append(Finding(
                    pass_id=PASS_ID, file=rel, line=lineno,
                    qualname=f"native.{getter}().{attr}",
                    code="native-missing-export",
                    message=f"{rel} calls {attr} on native.{getter}() but "
                            f"{cpp_name} exports no such method",
                    detail=f"{getter}.{attr}"))
        for name, lineno in sorted(exports.items()):
            if name not in uses[getter]:
                findings.append(Finding(
                    pass_id=PASS_ID, file=cpp_rel, line=lineno,
                    qualname=f"native.{getter}().{name}",
                    code="native-dead-export",
                    message=f"{cpp_name} exports {name} but no Python "
                            f"caller uses it — unpinned native path",
                    detail=f"{getter}.{name}"))
    return findings


# ----------------------------------------------------------------- runner --
def run(index: RepoIndex) -> List[Finding]:
    from accord_tpu_torch.host.wire import _MODULES
    from accord_tpu_torch.messages.base import MessageType
    from accord_tpu_torch.obs.flight import EVENT_KINDS

    findings: List[Finding] = []
    findings += verb_findings(index, [m.name for m in MessageType])
    findings += flight_findings(index, EVENT_KINDS)
    findings += instrumentation_findings(index)
    findings += wire_module_findings(index, _MODULES)
    findings += native_parity_findings(index)
    return findings
