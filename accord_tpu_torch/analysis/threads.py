"""Cross-thread shared-state audit.

Thread entry points are enumerated from the index: every
``threading.Thread(target=...)`` site (the WAL flush thread, the TCP
host loop thread, the Maelstrom stdin reader, httpd, workload pacers),
plus configured main-thread loops (``MaelstromHost.run``) and, for every
class defined in a thread-creating module, a pseudo-root per public
method (the "any thread may call this" API surface — the client
`_send_lock` users enter here).

Contexts are propagated over the call graph with the marshalling idioms
rewritten en route: a callback handed to ``call_soon``/``scheduler.once``
recolors to the owner's loop context, a function opening with the
``get_ident() != self._loop_tid`` guard converts *any* caller context to
its loop, and ``on_durable`` callbacks recolor to the flush thread.

Two rules over attribute mutations (``self.x = ...``, ``+=``, item
writes; ``__init__``/ctor-only writes exempt — construction
happens-before publication):

- **inconsistent-lock**: the attribute is written under a recognized
  lock somewhere and without it elsewhere;
- **unlocked-write**: the attribute is written from ≥2 distinct thread
  contexts and this site holds no lock (sites that only the loop writes
  are reported on the foreign-context side).

A write counts as locked if a lock is held lexically *or* every call
site of the enclosing function holds a common lock (the
``_mark_durable`` caller-holds-the-lock idiom, one level deep).

Known blind spot (documented, not a guarantee): container mutations via
method call (``self.xs.append(...)``) and attributes shared across
modules that never construct a thread are not audited.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import FunctionInfo, RepoIndex
from .findings import Finding

PASS_ID = "threads"

# main-thread loops that are thread contexts but not Thread targets
DEFAULT_EXTRA_ROOTS = ("accord_tpu_torch.host.maelstrom::MaelstromHost.run",)


def _loop_classes(index: RepoIndex) -> Set[str]:
    """Classes with a marshalling guard (or _loop_tid) own an event loop."""
    out: Set[str] = set()
    for fn in index.functions.values():
        if fn.has_marshal_guard and fn.cls:
            out.add(fn.cls)
    return out


def _color(index: RepoIndex, roots: Dict[str, str],
           loop_classes: Set[str]) -> Dict[str, Set[str]]:
    """Propagate thread-context colors over the call graph."""

    def loop_color(fn: FunctionInfo) -> Optional[str]:
        if fn.cls in loop_classes:
            return f"loop:{fn.cls}"
        return None

    colors: Dict[str, Set[str]] = {}
    queue: List[Tuple[str, str]] = []

    def add(qn: str, color: str) -> None:
        if qn not in index.functions:
            return
        fn = index.functions[qn]
        # a marshal guard converts any incoming context to the owner loop
        if fn.has_marshal_guard or fn.marshalled_to_loop:
            color = loop_color(fn) or color
        got = colors.setdefault(qn, set())
        if color not in got:
            got.add(color)
            queue.append((qn, color))

    for qn, color in roots.items():
        fn = index.functions.get(qn)
        if fn is None:
            continue
        # a loop class's thread target IS the loop: unify with loop color
        add(qn, (loop_color(fn) or color))

    while queue:
        cur, color = queue.pop(0)
        for edge in index.functions[cur].edges:
            nxt = color
            if edge.deferred:
                nxt = "thread:wal-flush"
            elif edge.marshalled:
                target = index.functions.get(edge.callee)
                if target is not None:
                    nxt = loop_color(target) or \
                        (loop_color(index.functions[cur]) or color)
            add(edge.callee, nxt)
    return colors


def _roots(index: RepoIndex,
           extra_roots: Sequence[str]) -> Dict[str, str]:
    """Real thread entry points only: Thread(target=...) sites plus the
    configured main-thread loops.  No speculative per-public-method
    contexts — a mutation is cross-thread when two *actual* entry points
    reach it, which keeps single-threaded drivers (host/runner.py's
    subprocess router, bench mains) out of the report."""
    roots: Dict[str, str] = {}
    for t in index.thread_targets:
        roots[t.target] = f"thread:{t.target.split('::')[-1]}"
    for qn in extra_roots:
        roots.setdefault(qn, f"main:{qn.split('::')[-1]}")
    return roots


def _caller_held_locks(index: RepoIndex, fn: FunctionInfo) -> Set[str]:
    """Common lock tokens held at EVERY call site of `fn` (one level)."""
    common: Optional[Set[str]] = None
    for other in index.functions.values():
        for edge in other.edges:
            if edge.callee != fn.qualname:
                continue
            held = set(edge.locks)
            common = held if common is None else (common & held)
            if not common:
                return set()
    return common or set()


def run(index: RepoIndex,
        extra_roots: Sequence[str] = DEFAULT_EXTRA_ROOTS) -> List[Finding]:
    # audited classes: defined in a module that constructs a thread (or
    # hosts a configured main-thread loop)
    threaded_modules = {
        index.functions[t.creator].module
        for t in index.thread_targets if t.creator in index.functions}
    for qn in extra_roots:
        if qn in index.functions:
            threaded_modules.add(index.functions[qn].module)
    audited = {qn for qn, cls in index.classes.items()
               if cls.module in threaded_modules}

    loop_classes = _loop_classes(index)
    # a class hosting a configured main-thread loop owns that loop too
    for qn in extra_roots:
        fn = index.functions.get(qn)
        if fn is not None and fn.cls:
            loop_classes.add(fn.cls)
    roots = _roots(index, extra_roots)
    colors = _color(index, roots, loop_classes)

    # ctor-only functions: every in-edge comes from the class's __init__
    in_edges: Dict[str, Set[str]] = {}
    for fn in index.functions.values():
        for e in fn.edges:
            in_edges.setdefault(e.callee, set()).add(fn.qualname)

    def ctor_only(fn: FunctionInfo) -> bool:
        if fn.name == "__init__":
            return True
        callers = in_edges.get(fn.qualname, set())
        return bool(callers) and all(
            c.endswith(".__init__") for c in callers)

    findings: List[Finding] = []
    for cls_qn in sorted(audited):
        cls = index.classes[cls_qn]
        # gather every mutation site per attribute across the class
        sites: Dict[str, List[Tuple[FunctionInfo, object, Set[str]]]] = {}
        for fq in cls.methods.values():
            for member in [fq] + [
                    f.qualname for f in index._children.get(fq, [])]:
                fn = index.functions[member]
                if ctor_only(fn):
                    continue
                held_by_callers = None
                for w in fn.self_writes:
                    locks = set(w.locks)
                    if not locks:
                        if held_by_callers is None:
                            held_by_callers = _caller_held_locks(index, fn)
                        locks |= held_by_callers
                    sites.setdefault(w.attr, []).append((fn, w, locks))
        for attr, writes in sorted(sites.items()):
            all_colors: Set[str] = set()
            for fn, w, _locks in writes:
                c = set(colors.get(fn.qualname, set()))
                if w.after_guard and fn.cls in loop_classes:
                    c = {f"loop:{fn.cls}"}
                all_colors |= c
            locked_somewhere = any(locks for _, _, locks in writes)
            for fn, w, locks in writes:
                c = colors.get(fn.qualname, set())
                if w.after_guard and fn.cls in loop_classes:
                    c = {f"loop:{fn.cls}"}
                if locks:
                    continue
                if locked_somewhere:
                    findings.append(Finding(
                        pass_id=PASS_ID, file=index.relpath(fn.path),
                        line=w.lineno, qualname=fn.qualname,
                        code="inconsistent-lock",
                        message=f"attribute {cls.name}.{attr} is written "
                                f"under a lock elsewhere but not here",
                        detail=attr))
                elif len(all_colors) >= 2 and c and \
                        not all(x.startswith("loop:") for x in all_colors):
                    others = sorted(all_colors - c) or sorted(all_colors)
                    findings.append(Finding(
                        pass_id=PASS_ID, file=index.relpath(fn.path),
                        line=w.lineno, qualname=fn.qualname,
                        code="unlocked-write",
                        message=f"attribute {cls.name}.{attr} written from "
                                f"{'/'.join(sorted(c))} without a lock; "
                                f"also written from {'/'.join(others)}",
                        detail=attr))
    return findings
