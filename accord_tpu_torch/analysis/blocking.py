"""Event-loop blocking-call detector.

Call-graph reachability from the selector-loop roots (`TcpHost._run` /
`_dispatch`, `MaelstromHost.run`) and from `Node._process` to blocking
primitives: `time.sleep`, `Condition`/`Event.wait`, `Thread.join`,
`Queue.get/put`, blocking socket/file ops, `os.fsync`, subprocess.

Deferred edges (callbacks handed to `WriteAheadLog.on_durable`) are not
followed — those run on the flush thread, the canonical declared
off-loop context.  Specific (function, primitive) pairs that *are* the
loop's own idle wait live in ALLOWED with a one-line justification each.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .core import RepoIndex
from .findings import Finding

PASS_ID = "blocking"

# external dotted calls that block the calling thread
BLOCKING_EXTERNALS = {
    "time.sleep",
    "os.fsync", "os.fdatasync", "os.system", "os.wait", "os.waitpid",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "socket.create_connection", "socket.getaddrinfo",
    "threading.Condition.wait", "threading.Event.wait",
    "threading.Thread.join",
    "queue.Queue.get", "queue.Queue.put",
    "socket.socket.connect", "socket.socket.accept",
    "socket.socket.sendall", "socket.socket.recv",
    "socket.socket.makefile",
}

# default loop roots for the real repo
DEFAULT_ROOTS = (
    "accord_tpu_torch.host.tcp::TcpHost._run",
    "accord_tpu_torch.host.tcp::TcpHost._dispatch",
    "accord_tpu_torch.host.maelstrom::MaelstromHost.run",
    "accord_tpu_torch.local.node::Node._process",
    "accord_tpu_torch.shard.worker::WorkerHost.run",
    "accord_tpu_torch.shard.worker::WorkerHost._dispatch",
)

# (function qualname, primitive) pairs that are the loop's own idle wait
# or an otherwise-declared off-loop blocking point; each needs a reason.
ALLOWED: Dict[Tuple[str, str], str] = {
    ("accord_tpu_torch.host.maelstrom::MaelstromHost.run", "queue.Queue.get"):
        "the Maelstrom loop's own poll: stdin lines arrive via the reader "
        "thread's queue, and this get(timeout=) IS the scheduler block",
    ("accord_tpu_torch.shard.worker::WorkerHost.run", "queue.Queue.get"):
        "the shard worker loop's own poll: pipe frames arrive via the "
        "reader thread's queue, and this get(timeout=) IS the scheduler "
        "block",
}


def run(index: RepoIndex, roots: Sequence[str] = DEFAULT_ROOTS,
        allowed: Dict[Tuple[str, str], str] = None) -> List[Finding]:
    allowed = ALLOWED if allowed is None else allowed
    findings: List[Finding] = []
    paths = index.reachable(roots, skip_deferred=True)
    for qn, path in paths.items():
        fn = index.functions[qn]
        for ext in fn.externals:
            if ext.name not in BLOCKING_EXTERNALS:
                continue
            if (qn, ext.name) in allowed:
                continue
            via = " -> ".join(p.split("::")[-1] for p in path)
            findings.append(Finding(
                pass_id=PASS_ID,
                file=index.relpath(fn.path),
                line=ext.lineno,
                qualname=qn,
                code="blocking-call",
                message=f"{ext.name} reachable from loop root "
                        f"{path[0].split('::')[-1]} via {via}",
                detail=f"{ext.name}@root={path[0].split('::')[-1]}"))
    return findings
