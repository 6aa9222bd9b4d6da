"""Shared AST index for accord-lint (`accord_tpu_torch.analysis`).

One parse of the package tree feeds every pass: a module index (imports
resolved, module-level types), a class table (base classes plus attribute
types inferred from ``self.x = Ctor(...)`` bindings), and an approximate
call graph keyed by qualnames (``pkg.mod::Class.method``).

Resolution policy is precision-over-recall: an edge is only created when
the callee can be pinned down — direct names, ``self.method`` through the
repo-local MRO, receivers whose type was inferred from a constructor
binding, or (last resort) a bare method name defined by at most
``AMBIG_CAP`` classes repo-wide.  Anything else gets *no* edge; passes
that care about specific primitives (``time.sleep``, ``os.fsync``,
``Condition.wait``) match them at the call site through the resolved
external-call list instead of chasing unresolvable dispatch.

Thread/marshalling idioms the index understands:

- ``threading.Thread(target=fn)`` records a thread entry point, not an
  edge (the target runs on its own thread, never the caller's);
- callbacks handed to ``call_soon`` / ``scheduler.once`` / ``.at`` are
  marked ``marshalled_to_loop`` (the wakeup-socketpair idiom);
- callbacks handed to ``on_durable`` are *deferred* edges (they fire on
  the WAL flush thread) and are skipped by loop reachability;
- the ``if threading.get_ident() != self._loop_tid: self.call_soon(...);
  return`` guard makes everything after it loop-context.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# receivers typed as one of these count as lock-like for `with` tracking
LOCK_TYPES = {"threading.Lock", "threading.RLock", "threading.Condition"}
# bare-name fallback resolution: give up beyond this many candidates
AMBIG_CAP = 4
# never bare-name-resolve these: they collide with builtin collection /
# socket / file APIs on untyped receivers and fabricate edges
AMBIG_EXCLUDED = {
    "append", "appendleft", "extend", "insert", "add", "remove", "discard",
    "pop", "popleft", "clear", "update", "get", "put", "setdefault", "sort",
    "join", "split", "strip", "read", "write", "close", "open", "send",
    "recv", "count", "index", "copy", "keys", "values", "items", "flush",
}
# method calls on self attributes that mutate the receiver in place
# (audited as writes by the threads pass)
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "insert", "add", "remove", "discard",
    "pop", "popleft", "popitem", "clear", "update", "setdefault", "sort",
    "reverse",
}
# function-reference sinks that marshal the callback onto the event loop
MARSHAL_SINKS = {"call_soon", "once", "at"}
# function-reference sinks that defer the callback to another thread
DEFERRED_SINKS = {"on_durable"}
# external type prefixes worth remembering in attribute-type inference
_EXTERNAL_TYPE_PREFIXES = ("threading.", "queue.", "socket.", "selectors.",
                           "subprocess.", "collections.")


@dataclass
class CallEdge:
    caller: str
    callee: str                 # repo-local qualname
    lineno: int
    kind: str                   # direct | ctor | ambiguous | callback
    deferred: bool = False      # fires on another thread (on_durable)
    marshalled: bool = False    # fires on the owner's event loop (call_soon)
    locks: Tuple[str, ...] = () # lock tokens held lexically at the call site


@dataclass
class ExternalCall:
    name: str                   # dotted, e.g. "time.sleep", "threading.Condition.wait"
    lineno: int


@dataclass
class SelfWrite:
    attr: str
    lineno: int
    locks: Tuple[str, ...]      # lock tokens held lexically at the write
    kind: str                   # assign | augassign | item | del
    after_guard: bool           # past the get_ident()/call_soon marshal guard


@dataclass
class FunctionInfo:
    qualname: str
    module: str
    cls: Optional[str]          # owning class qualname, or None
    name: str
    node: ast.AST
    path: Path
    lineno: int
    parent: Optional[str] = None        # enclosing function (nested defs)
    edges: List[CallEdge] = field(default_factory=list)
    externals: List[ExternalCall] = field(default_factory=list)
    self_writes: List[SelfWrite] = field(default_factory=list)
    has_marshal_guard: bool = False
    marshalled_to_loop: bool = False    # passed to call_soon/scheduler


@dataclass
class ClassInfo:
    qualname: str
    module: str
    name: str
    node: ast.ClassDef
    lineno: int
    bases: List[str] = field(default_factory=list)      # resolved dotted/qualnames
    attr_types: Dict[str, str] = field(default_factory=dict)
    methods: Dict[str, str] = field(default_factory=dict)  # bare -> qualname


@dataclass
class ModuleInfo:
    name: str
    path: Path
    tree: ast.Module
    is_package: bool
    imports: Dict[str, str] = field(default_factory=dict)  # local name -> dotted
    global_types: Dict[str, str] = field(default_factory=dict)
    import_targets: Set[str] = field(default_factory=set)  # dotted modules imported


@dataclass
class ThreadTarget:
    creator: str                # function qualname containing Thread(...)
    target: str                 # resolved function qualname
    lineno: int


class RepoIndex:
    """Parsed view of one package tree; built once, shared by every pass."""

    def __init__(self, root: Path, package: str):
        self.root = Path(root)
        self.package = package
        self.modules: Dict[str, ModuleInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.methods_by_name: Dict[str, List[str]] = {}
        self.thread_targets: List[ThreadTarget] = []
        self._children: Dict[str, List[FunctionInfo]] = {}

    # ------------------------------------------------------------ building --
    @classmethod
    def build(cls, root: Path, package: Optional[str] = None) -> "RepoIndex":
        root = Path(root)
        index = cls(root, package or root.name)
        for path in sorted(root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = path.relative_to(root)
            parts = [index.package] + list(rel.parts[:-1])
            if rel.name != "__init__.py":
                parts.append(rel.stem)
            name = ".".join(parts)
            try:
                tree = ast.parse(path.read_text(), filename=str(path))
            except SyntaxError:
                continue
            index.modules[name] = ModuleInfo(
                name=name, path=path, tree=tree,
                is_package=(rel.name == "__init__.py"))
        for mod in index.modules.values():
            index._index_imports(mod)
            index._index_defs(mod)
        for mod in index.modules.values():
            index._index_types(mod)
        for f in index.functions.values():
            if f.parent is not None:
                index._children.setdefault(f.parent, []).append(f)
        for mod in index.modules.values():
            index._analyze_bodies(mod)
        return index

    def _index_imports(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        mod.imports[a.asname] = a.name
                    else:
                        head = a.name.split(".")[0]
                        mod.imports[head] = head
                    mod.import_targets.add(a.name)
            elif isinstance(node, ast.ImportFrom):
                base = self._resolve_from(mod, node)
                if base is None:
                    continue
                mod.import_targets.add(base)
                for a in node.names:
                    if a.name == "*":
                        continue
                    mod.imports[a.asname or a.name] = f"{base}.{a.name}"

    def _resolve_from(self, mod: ModuleInfo, node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module
        parts = mod.name.split(".")
        if not mod.is_package:
            parts = parts[:-1]
        drop = node.level - 1
        if drop:
            if drop >= len(parts):
                return None
            parts = parts[:-drop]
        if node.module:
            parts = parts + node.module.split(".")
        return ".".join(parts) if parts else None

    def _index_defs(self, mod: ModuleInfo) -> None:
        def visit(body, cls_qn: Optional[str], parent_fn: Optional[str]):
            for node in body:
                if isinstance(node, ast.ClassDef) and parent_fn is None:
                    qn = f"{mod.name}::{node.name}"
                    self.classes[qn] = ClassInfo(
                        qualname=qn, module=mod.name, name=node.name,
                        node=node, lineno=node.lineno)
                    visit(node.body, qn, None)
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if parent_fn is not None:
                        fq = f"{parent_fn}.{node.name}"
                    elif cls_qn is not None:
                        fq = f"{cls_qn.split('::')[0]}::" \
                             f"{cls_qn.split('::')[1]}.{node.name}"
                    else:
                        fq = f"{mod.name}::{node.name}"
                    info = FunctionInfo(
                        qualname=fq, module=mod.name, cls=cls_qn,
                        name=node.name, node=node, path=mod.path,
                        lineno=node.lineno, parent=parent_fn)
                    self.functions[fq] = info
                    if cls_qn is not None and parent_fn is None:
                        self.classes[cls_qn].methods[node.name] = fq
                        self.methods_by_name.setdefault(node.name, []).append(fq)
                    visit(node.body, cls_qn, fq)

        visit(mod.tree.body, None, None)

    # ---------------------------------------------------------- resolution --
    def resolve_name(self, mod: ModuleInfo, name: str) -> Optional[str]:
        """Dotted target for a bare name in `mod`: local def, then import."""
        if f"{mod.name}::{name}" in self.classes:
            return f"{mod.name}.{name}"
        if f"{mod.name}::{name}" in self.functions:
            return f"{mod.name}.{name}"
        if name in mod.imports:
            return mod.imports[name]
        return None

    def dotted_of(self, mod: ModuleInfo, expr: ast.AST) -> Optional[str]:
        """Resolve Name / Attribute-chain expressions to a dotted path."""
        if isinstance(expr, ast.Name):
            return self.resolve_name(mod, expr.id)
        if isinstance(expr, ast.Attribute):
            base = self.dotted_of(mod, expr.value)
            if base is None:
                return None
            return f"{base}.{expr.attr}"
        return None

    def lookup(self, dotted: str) -> Optional[Tuple[str, str]]:
        """Map a dotted path to a repo entity: ('func'|'class', qualname)."""
        if "." not in dotted:
            return None
        mod_name, _, leaf = dotted.rpartition(".")
        # the binding may point one module deep (from pkg.mod import X)
        for candidate_mod, candidate_leaf in ((mod_name, leaf), (dotted, None)):
            if candidate_mod in self.modules and candidate_leaf:
                qn = f"{candidate_mod}::{candidate_leaf}"
                if qn in self.classes:
                    return ("class", qn)
                if qn in self.functions:
                    return ("func", qn)
        return None

    def mro_lookup(self, cls_qn: str, method: str,
                   _seen: Optional[Set[str]] = None) -> Optional[str]:
        """Find `method` on the class or its repo-local bases."""
        seen = _seen or set()
        if cls_qn in seen or cls_qn not in self.classes:
            return None
        seen.add(cls_qn)
        info = self.classes[cls_qn]
        if method in info.methods:
            return info.methods[method]
        for base in info.bases:
            ent = self.lookup(base)
            if ent and ent[0] == "class":
                found = self.mro_lookup(ent[1], method, seen)
                if found:
                    return found
        return None

    # -------------------------------------------------------------- typing --
    def _infer_type(self, mod: ModuleInfo, expr: ast.AST) -> Optional[str]:
        """Type of an expression, for constructor calls only."""
        if not isinstance(expr, ast.Call):
            return None
        dotted = self.dotted_of(mod, expr.func)
        if dotted is None:
            return None
        ent = self.lookup(dotted)
        if ent and ent[0] == "class":
            return ent[1]
        if dotted.startswith(_EXTERNAL_TYPE_PREFIXES):
            return dotted
        return None

    def _index_types(self, mod: ModuleInfo) -> None:
        # resolve class bases now that every module's defs are known
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
                t = self._infer_type(mod, stmt.value)
                if t:
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            mod.global_types[tgt.id] = t
        for cls in self.classes.values():
            if cls.module != mod.name:
                continue
            for b in cls.node.bases:
                dotted = self.dotted_of(mod, b)
                if dotted:
                    cls.bases.append(dotted)
            for fq in cls.methods.values():
                fn = self.functions[fq]
                for node in ast.walk(fn.node):
                    tgt = val = None
                    if isinstance(node, ast.Assign) and len(node.targets) == 1:
                        tgt, val = node.targets[0], node.value
                    elif isinstance(node, ast.AnnAssign) and node.value is not None:
                        tgt, val = node.target, node.value
                    if (tgt is not None and isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        t = self._infer_type(mod, val)
                        if t and tgt.attr not in cls.attr_types:
                            cls.attr_types[tgt.attr] = t

    # ---------------------------------------------------------- body walks --
    def _analyze_bodies(self, mod: ModuleInfo) -> None:
        for fn in self.functions.values():
            if fn.module == mod.name:
                _BodyWalker(self, mod, fn).run()

    # --------------------------------------------------------- reachability --
    def reachable(self, roots: Sequence[str], *,
                  skip_deferred: bool = True,
                  follow_marshalled: bool = True,
                  ) -> Dict[str, Tuple[str, ...]]:
        """BFS over call edges; returns qualname -> path-from-root."""
        paths: Dict[str, Tuple[str, ...]] = {}
        queue: List[str] = []
        for r in roots:
            if r in self.functions and r not in paths:
                paths[r] = (r,)
                queue.append(r)
        while queue:
            cur = queue.pop(0)
            for edge in self.functions[cur].edges:
                if skip_deferred and edge.deferred:
                    continue
                if not follow_marshalled and edge.marshalled:
                    continue
                nxt = edge.callee
                if nxt in self.functions and nxt not in paths:
                    paths[nxt] = paths[cur] + (nxt,)
                    queue.append(nxt)
        return paths

    def relpath(self, path: Path) -> str:
        try:
            return str(Path(path).relative_to(self.root.parent))
        except ValueError:
            return str(path)


class _BodyWalker:
    """Single walk of one function body: edges, externals, writes, guard."""

    def __init__(self, index: RepoIndex, mod: ModuleInfo, fn: FunctionInfo):
        self.index = index
        self.mod = mod
        self.fn = fn
        self.locals_types: Dict[str, Optional[str]] = {}
        self.lock_stack: List[str] = []
        self.guard_end: Optional[int] = None
        # nested defs visible by bare name: own children, then siblings and
        # the enclosing chain's children (closure scope, deepest wins)
        scopes = []
        anc: Optional[str] = fn.qualname
        while anc is not None:
            scopes.append(anc)
            anc = index.functions[anc].parent if anc in index.functions else None
        self.nested: Dict[str, str] = {}
        for scope in reversed(scopes):
            for f in index._children.get(scope, []):
                self.nested[f.name] = f.qualname

    def run(self) -> None:
        node = self.fn.node
        self.guard_end = self._find_marshal_guard(node)
        self.fn.has_marshal_guard = self.guard_end is not None
        self._infer_locals(node)
        for stmt in node.body:
            self._visit(stmt)

    # -- marshal guard: if get_ident() != self._loop_tid: call_soon(); return
    def _find_marshal_guard(self, node: ast.AST) -> Optional[int]:
        for stmt in getattr(node, "body", []):
            if not isinstance(stmt, ast.If):
                continue
            names = {n.id for n in ast.walk(stmt.test)
                     if isinstance(n, ast.Name)}
            attrs = {n.attr for n in ast.walk(stmt.test)
                     if isinstance(n, ast.Attribute)}
            if "get_ident" not in (names | attrs):
                continue
            has_marshal = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in MARSHAL_SINKS
                for s in stmt.body for n in ast.walk(s))
            has_return = any(
                isinstance(n, ast.Return)
                for s in stmt.body for n in ast.walk(s))
            if has_marshal and has_return:
                return stmt.end_lineno or stmt.lineno
        return None

    def _infer_locals(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and sub is not node:
                continue
            tgt = val = None
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                tgt, val = sub.targets[0], sub.value
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                tgt, val = sub.target, sub.value
            if tgt is None or not isinstance(tgt, ast.Name):
                continue
            t = self.index._infer_type(self.mod, val)
            if tgt.id in self.locals_types and self.locals_types[tgt.id] != t:
                self.locals_types[tgt.id] = None     # conflicting rebind
            else:
                self.locals_types[tgt.id] = t

    # ------------------------------------------------------------- walking --
    def _visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                       # nested defs walk themselves
        if isinstance(node, ast.With):
            tokens = [self._lock_token(item.context_expr)
                      for item in node.items]
            tokens = [t for t in tokens if t]
            self.lock_stack.extend(tokens)
            for stmt in node.body:
                self._visit(stmt)
            for _ in tokens:
                self.lock_stack.pop()
            for item in node.items:
                self._visit(item.context_expr)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node)
        self._collect_write(node)
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _lock_token(self, expr: ast.AST) -> Optional[str]:
        t = self._receiver_type(expr)
        if t in LOCK_TYPES:
            return ast.dump(expr) if not isinstance(expr, (ast.Name, ast.Attribute)) \
                else self._expr_token(expr)
        return None

    def _expr_token(self, expr: ast.AST) -> str:
        if isinstance(expr, ast.Name):
            return expr.id
        if isinstance(expr, ast.Attribute):
            return f"{self._expr_token(expr.value)}.{expr.attr}"
        return "<expr>"

    def _receiver_type(self, expr: ast.AST) -> Optional[str]:
        """Inferred type of a receiver expression, or None."""
        if isinstance(expr, ast.Name):
            if expr.id in self.locals_types:
                return self.locals_types[expr.id]
            if expr.id in self.mod.global_types:
                return self.mod.global_types[expr.id]
            return None
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            if self.fn.cls and self.fn.cls in self.index.classes:
                return self.index.classes[self.fn.cls].attr_types.get(expr.attr)
        return None

    # --------------------------------------------------------------- calls --
    def _visit_call(self, call: ast.Call) -> None:
        fn, index, mod = self.fn, self.index, self.mod
        func = call.func
        callee_attr_name: Optional[str] = None
        callee_dotted: Optional[str] = None
        resolved = False

        if isinstance(func, ast.Name):
            name = func.id
            if name in self.nested:
                self._add_edge(self.nested[name], call.lineno, "direct")
                resolved = True
            else:
                dotted = index.resolve_name(mod, name)
                if dotted:
                    callee_dotted = dotted
                    ent = index.lookup(dotted)
                    if ent and ent[0] == "func":
                        self._add_edge(ent[1], call.lineno, "direct")
                        resolved = True
                    elif ent and ent[0] == "class":
                        init = index.mro_lookup(ent[1], "__init__")
                        if init:
                            self._add_edge(init, call.lineno, "ctor")
                        resolved = True
                    else:
                        fn.externals.append(ExternalCall(dotted, call.lineno))
                        resolved = True
                elif name == "id":
                    fn.externals.append(ExternalCall("builtins.id", call.lineno))
                    resolved = True
                elif name == "super":
                    resolved = True
        elif isinstance(func, ast.Attribute):
            callee_attr_name = func.attr
            recv = func.value
            # self.method(...) through the repo-local MRO
            if isinstance(recv, ast.Name) and recv.id == "self" and fn.cls:
                target = index.mro_lookup(fn.cls, func.attr)
                if target:
                    self._add_edge(target, call.lineno, "direct")
                    resolved = True
            # super().method(...)
            elif (isinstance(recv, ast.Call)
                    and isinstance(recv.func, ast.Name)
                    and recv.func.id == "super" and fn.cls):
                for base in self.index.classes[fn.cls].bases \
                        if fn.cls in self.index.classes else []:
                    ent = index.lookup(base)
                    if ent and ent[0] == "class":
                        target = index.mro_lookup(ent[1], func.attr)
                        if target:
                            self._add_edge(target, call.lineno, "direct")
                            resolved = True
                            break
            if not resolved:
                dotted = index.dotted_of(mod, recv)
                if dotted is not None:
                    full = f"{dotted}.{func.attr}"
                    callee_dotted = full
                    ent = index.lookup(full)
                    if ent and ent[0] == "func":
                        self._add_edge(ent[1], call.lineno, "direct")
                        resolved = True
                    elif ent and ent[0] == "class":
                        init = index.mro_lookup(ent[1], "__init__")
                        if init:
                            self._add_edge(init, call.lineno, "ctor")
                        resolved = True
                    elif dotted in mod.imports.values() or \
                            dotted.split(".")[0] in mod.imports.values():
                        fn.externals.append(ExternalCall(full, call.lineno))
                        resolved = True
            if not resolved:
                rtype = self._receiver_type(recv)
                if rtype is not None:
                    if rtype in index.classes:
                        target = index.mro_lookup(rtype, func.attr)
                        if target:
                            self._add_edge(target, call.lineno, "direct")
                        resolved = True
                    else:
                        fn.externals.append(
                            ExternalCall(f"{rtype}.{func.attr}", call.lineno))
                        resolved = True
            if not resolved and func.attr not in AMBIG_EXCLUDED:
                # bare-name fallback under the ambiguity cap
                cands = index.methods_by_name.get(func.attr, [])
                if 0 < len(cands) <= AMBIG_CAP:
                    for c in cands:
                        self._add_edge(c, call.lineno, "ambiguous")
                    resolved = True
            # self.<attr>.<mutator>(...) mutates the attribute in place
            if func.attr in MUTATOR_METHODS \
                    and isinstance(recv, ast.Attribute) \
                    and isinstance(recv.value, ast.Name) \
                    and recv.value.id == "self":
                after = self.guard_end is not None \
                    and call.lineno > self.guard_end
                self.fn.self_writes.append(SelfWrite(
                    attr=recv.attr, lineno=call.lineno,
                    locks=tuple(self.lock_stack), kind="method",
                    after_guard=after))

        self._visit_callback_args(call, callee_dotted, callee_attr_name)

    def _visit_callback_args(self, call: ast.Call,
                             callee_dotted: Optional[str],
                             callee_attr: Optional[str]) -> None:
        """Function references passed as arguments: thread targets,
        marshalled loop callbacks, deferred durability callbacks, or
        plain same-context continuations."""
        index, fn = self.index, self.fn
        is_thread = callee_dotted == "threading.Thread"
        refs: List[Tuple[Optional[str], str]] = []   # (kw, target qualname)
        for kw, arg in ([(None, a) for a in call.args]
                        + [(k.arg, k.value) for k in call.keywords]):
            target = self._func_ref(arg)
            if target:
                refs.append((kw, target))
        for kw, target in refs:
            if is_thread:
                if kw in (None, "target"):
                    index.thread_targets.append(
                        ThreadTarget(fn.qualname, target, call.lineno))
                continue
            deferred = callee_attr in DEFERRED_SINKS
            marshalled = callee_attr in MARSHAL_SINKS
            if marshalled and target in index.functions:
                index.functions[target].marshalled_to_loop = True
            fn.edges.append(CallEdge(
                caller=fn.qualname, callee=target, lineno=call.lineno,
                kind="callback", deferred=deferred, marshalled=marshalled,
                locks=tuple(self.lock_stack)))

    def _func_ref(self, expr: ast.AST) -> Optional[str]:
        """Resolve a non-called function reference to a qualname."""
        if isinstance(expr, ast.Name):
            if expr.id in self.nested:
                return self.nested[expr.id]
            dotted = self.index.resolve_name(self.mod, expr.id)
            if dotted:
                ent = self.index.lookup(dotted)
                if ent and ent[0] == "func":
                    return ent[1]
        elif isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and self.fn.cls:
            return self.index.mro_lookup(self.fn.cls, expr.attr)
        elif isinstance(expr, ast.Lambda):
            # lambdas are anonymous: approximate by linking the refs inside
            for sub in ast.walk(expr.body):
                t = None
                if isinstance(sub, ast.Call):
                    t = self._func_ref(sub.func)
                if t:
                    self.fn.edges.append(CallEdge(
                        caller=self.fn.qualname, callee=t,
                        lineno=expr.lineno, kind="callback",
                        locks=tuple(self.lock_stack)))
            return None
        return None

    def _add_edge(self, callee: str, lineno: int, kind: str) -> None:
        self.fn.edges.append(CallEdge(
            caller=self.fn.qualname, callee=callee, lineno=lineno, kind=kind,
            locks=tuple(self.lock_stack)))

    # -------------------------------------------------------------- writes --
    def _collect_write(self, node: ast.AST) -> None:
        targets: List[Tuple[ast.AST, str]] = []
        if isinstance(node, ast.Assign):
            targets = [(t, "assign") for t in node.targets]
        elif isinstance(node, ast.AugAssign):
            targets = [(node.target, "augassign")]
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [(node.target, "assign")]
        elif isinstance(node, ast.Delete):
            targets = [(t, "del") for t in node.targets]
        for tgt, kind in targets:
            attr = None
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
                attr = tgt.attr
            elif isinstance(tgt, ast.Subscript):
                inner = tgt.value
                if isinstance(inner, ast.Attribute) and \
                        isinstance(inner.value, ast.Name) and \
                        inner.value.id == "self":
                    attr, kind = inner.attr, "item"
            if attr is None:
                continue
            after = self.guard_end is not None and node.lineno > self.guard_end
            self.fn.self_writes.append(SelfWrite(
                attr=attr, lineno=node.lineno,
                locks=tuple(self.lock_stack), kind=kind, after_guard=after))


def build_package_index() -> RepoIndex:
    """Index the installed accord_tpu_torch package (the usual entry point)."""
    import accord_tpu_torch
    root = Path(accord_tpu_torch.__file__).parent
    return RepoIndex.build(root, "accord_tpu_torch")
