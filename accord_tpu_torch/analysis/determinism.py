"""Sim-determinism lint.

Burn bit-identity holds only if protocol code reachable from the sim
makes no decision from a wall clock, the module-global `random`, object
identity, set iteration order, or ad-hoc environment reads.  Scope is
the module import closure of `accord_tpu_torch.sim` intersected with the
protocol packages (local, coordinate, messages, impl, primitives,
topology, utils, api, sim) — the code a burn actually executes.

Deliberate carve-outs (not baselined, excluded by design):

- `accord_tpu_torch.obs.*`: observability measures real time by contract; the
  PR-2 invariant that obs never feeds protocol decisions is enforced
  structurally by the layering pass (obs imports nothing from the
  protocol), not by banning clocks inside it.
- `accord_tpu_torch.utils.random_source`: the seeded RandomSource wrapper is
  the sanctioned owner of the stdlib `random` import.
- functions named `from_env` / `*_from_env` / `_env*` and module-level
  statements: config load is where env reads belong.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Sequence, Set

from .core import FunctionInfo, RepoIndex
from .findings import Finding

PASS_ID = "determinism"

WALL_CLOCKS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today",
}
RANDOM_DRAWS = {
    "random." + n for n in (
        "random", "randint", "randrange", "choice", "choices", "shuffle",
        "sample", "uniform", "gauss", "seed", "getrandbits", "expovariate",
        "betavariate", "triangular", "vonmisesvariate")
}
ENV_READS = {"os.getenv", "os.environ.get", "os.environ.setdefault"}

PROTOCOL_PACKAGES = ("sim", "local", "coordinate", "messages", "impl",
                     "primitives", "topology", "utils", "api")
EXCLUDE_PREFIXES = ("accord_tpu_torch.obs", "accord_tpu_torch.analysis",
                    "accord_tpu_torch.utils.random_source")


def _sim_scope(index: RepoIndex) -> Set[str]:
    """Import closure of <pkg>.sim, restricted to protocol packages."""
    pkg = index.package
    allowed = {f"{pkg}.{p}" for p in PROTOCOL_PACKAGES}

    def in_protocol(name: str) -> bool:
        return name == pkg or any(
            name == a or name.startswith(a + ".") for a in allowed)

    roots = [m for m in index.modules if m.startswith(f"{pkg}.sim")]
    seen: Set[str] = set()
    queue = list(roots)
    while queue:
        cur = queue.pop()
        if cur in seen or cur not in index.modules:
            continue
        seen.add(cur)
        for target in index.modules[cur].import_targets:
            for name in (target, target.rpartition(".")[0]):
                if name and name not in seen and name in index.modules \
                        and in_protocol(name):
                    queue.append(name)
    return {m for m in seen if in_protocol(m)}


def _is_config_load(fn: FunctionInfo) -> bool:
    return (fn.name == "from_env" or fn.name.endswith("_from_env")
            or fn.name.startswith("_env"))


# consuming a set through these erases iteration order, so a
# comprehension fed straight into one is deterministic
ORDER_INSENSITIVE_SINKS = frozenset(
    {"sorted", "min", "max", "sum", "len", "any", "all",
     "set", "frozenset"})


def _set_iteration_sites(fn: FunctionInfo) -> List[int]:
    """`for x in {…}` / `for x in set(…)` — order-dependent iteration."""
    sites: List[int] = []
    set_locals: Set[str] = set()
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            if isinstance(node.value, ast.Set) or (
                    isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                    and node.value.func.id in ("set", "frozenset")):
                set_locals.add(node.targets[0].id)
            elif node.targets[0].id in set_locals:
                set_locals.discard(node.targets[0].id)
    # comprehensions handed directly to an order-insensitive consumer
    # (`tuple(sorted(t for t in dep_set))`) are fine
    laundered: Set[int] = set()
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ORDER_INSENSITIVE_SINKS:
            for arg in node.args:
                if isinstance(arg, (ast.ListComp, ast.SetComp,
                                    ast.GeneratorExp)):
                    laundered.add(id(arg))
    iters: List[ast.expr] = []
    for node in ast.walk(fn.node):
        if isinstance(node, ast.For):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            if id(node) in laundered:
                continue
            iters.extend(g.iter for g in node.generators)
    for it in iters:
        if isinstance(it, ast.Set):
            sites.append(it.lineno)
        elif isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id in ("set", "frozenset"):
            sites.append(it.lineno)
        elif isinstance(it, ast.Name) and it.id in set_locals:
            sites.append(it.lineno)
    return sites


def _env_subscript_sites(index: RepoIndex, fn: FunctionInfo) -> List[int]:
    """`os.environ[...]` reads (not calls, so not in the externals list)."""
    mod = index.modules[fn.module]
    sites: List[int] = []
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and index.dotted_of(mod, node.value) == "os.environ":
            sites.append(node.lineno)
    return sites


def run(index: RepoIndex, scope: Optional[Iterable[str]] = None,
        exclude_prefixes: Sequence[str] = EXCLUDE_PREFIXES) -> List[Finding]:
    if scope is None:
        scope_set = _sim_scope(index)
    else:
        scope_set = set(scope)
    findings: List[Finding] = []
    for fn in index.functions.values():
        if fn.module not in scope_set:
            continue
        if any(fn.module == p or fn.module.startswith(p + ".")
               for p in exclude_prefixes):
            continue
        rel = index.relpath(fn.path)

        def emit(line: int, code: str, msg: str, detail: str) -> None:
            findings.append(Finding(
                pass_id=PASS_ID, file=rel, line=line, qualname=fn.qualname,
                code=code, message=msg, detail=detail))

        config_load = _is_config_load(fn)
        for ext in fn.externals:
            if ext.name in WALL_CLOCKS:
                emit(ext.lineno, "wall-clock",
                     f"wall-clock read {ext.name} in sim-reachable code",
                     ext.name)
            elif ext.name in RANDOM_DRAWS:
                emit(ext.lineno, "global-random",
                     f"module-global {ext.name} — draw from a seeded "
                     f"RandomSource instead", ext.name)
            elif ext.name == "builtins.id":
                emit(ext.lineno, "id-keyed",
                     "id() in sim-reachable code — identity keys are "
                     "address-dependent across runs", "builtins.id")
            elif ext.name in ENV_READS and not config_load:
                emit(ext.lineno, "env-read",
                     f"{ext.name} outside config load", ext.name)
        if not config_load:
            for line in _env_subscript_sites(index, fn):
                emit(line, "env-read",
                     "os.environ[...] read outside config load",
                     "os.environ[]")
        for line in _set_iteration_sites(fn):
            emit(line, "set-iteration",
                 "iteration over a set — order is hash-seed dependent; "
                 "sort first if anything order-sensitive happens",
                 "set-iter")
    return findings
