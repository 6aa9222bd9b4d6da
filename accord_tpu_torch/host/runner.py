"""Black-box cluster runner over real Maelstrom host subprocesses.

Reference: accord-maelstrom's Cluster.java (the in-JVM runner driving nodes
through the same JSON wire format Maelstrom itself would use). Ours goes one
step further out of the box: each node is a separate OS process running
`python -m accord_tpu_torch.host.maelstrom`, the runner routes envelopes between
their stdios, plays a randomized append/read workload as Maelstrom clients,
and feeds the observed results to the burn test's strict-serializability
verifier (sim/verify.py) with final states obtained through ordinary
linearizable read transactions — fully black-box.
"""

from __future__ import annotations

import json
import queue
import random
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from accord_tpu_torch.host.maelstrom import key_token
from accord_tpu_torch.sim.verify import Observation, StrictSerializabilityVerifier


class HostProcess:
    """One node subprocess; a reader thread enqueues its stdout lines."""

    def __init__(self, name: str, inbox: "queue.Queue",
                 extra_env: Optional[dict] = None):
        import os
        env = dict(os.environ)
        env.setdefault("JAX_PLATFORMS", "cpu")  # hosts never need the chip
        if extra_env:
            env.update(extra_env)
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "accord_tpu_torch.host.maelstrom"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, bufsize=1, env=env)
        self.stderr_tail: List[str] = []

        def reader():
            for line in self.proc.stdout:
                inbox.put((name, line))

        def drain_stderr():
            # never let the child block on a full stderr pipe; keep a tail
            # for diagnostics
            for line in self.proc.stderr:
                self.stderr_tail.append(line.rstrip())
                del self.stderr_tail[:-50]

        threading.Thread(target=reader, daemon=True).start()
        threading.Thread(target=drain_stderr, daemon=True).start()

    def send(self, envelope: dict) -> None:
        self.proc.stdin.write(json.dumps(envelope) + "\n")
        self.proc.stdin.flush()

    def close(self) -> None:
        try:
            self.proc.stdin.close()
        except Exception:  # noqa: BLE001
            pass
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()  # a wedged child must not abort teardown
            self.proc.wait(timeout=10)


class MaelstromRunner:
    """Drives N host processes; acts as all Maelstrom clients at once."""

    def __init__(self, n_nodes: int = 3, seed: int = 0,
                 pipeline: bool = False, journal_dir: Optional[str] = None):
        self.names = [f"n{i + 1}" for i in range(n_nodes)]
        self.inbox: "queue.Queue" = queue.Queue()
        # pipeline=True turns on the continuous micro-batching ingest layer
        # in every node process (accord_tpu_torch/pipeline/, ACCORD_PIPELINE=1);
        # journal_dir points every node process at a durable write-ahead
        # journal (ACCORD_JOURNAL; accord_tpu_torch/journal/), which also makes
        # restart_node a black-box crash test: kill -9 + respawn + replay
        self._extra_env: Dict[str, str] = {}
        if pipeline:
            self._extra_env["ACCORD_PIPELINE"] = "1"
        if journal_dir is not None:
            self._extra_env["ACCORD_JOURNAL"] = journal_dir
        extra_env = self._extra_env or None
        self.procs: Dict[str, HostProcess] = {
            name: HostProcess(name, self.inbox, extra_env=extra_env)
            for name in self.names}
        self.seed = seed
        self._msg_seq = 0
        self.pending: Dict[int, dict] = {}   # msg_id -> op record
        self.results: List[dict] = []
        self.init_acks: set = set()
        # QoS-nack honor (qos/): a code-11 error carrying retry_after_us is
        # resubmitted after the hinted backoff (with jitter) instead of
        # being finalized — up to qos_max_retries attempts per op
        self.qos_max_retries = 3
        self.qos_nacks = 0
        self.qos_retries = 0
        self._retryq: List[Tuple[int, dict]] = []  # (due_us, op record)
        self._retry_rng = random.Random(seed ^ 0x51C)
        # appended values must be unique across the runner's LIFETIME, not
        # per workload call: a crash-restart harness runs several phases
        # against the same cluster and verifies them together
        self._next_value = 0

    # ----------------------------------------------------------- plumbing --
    def _route(self, envelope: dict) -> None:
        dest = envelope.get("dest", "")
        body = envelope.get("body", {})
        if body.get("type") == "init_ok":
            self.init_acks.add(envelope.get("src"))
            return
        if dest in self.procs:
            self.procs[dest].send(envelope)
        elif dest.startswith("c"):
            rec = self.pending.pop(body.get("in_reply_to"), None)
            if rec is not None:
                if body.get("qos") and body.get("retry_after_us") is not None \
                        and rec.get("attempt", 0) < self.qos_max_retries:
                    self.qos_nacks += 1
                    attempt = rec.get("attempt", 0) + 1
                    rec["attempt"] = attempt
                    base = min(2_000_000, int(body["retry_after_us"])
                               * (2 ** (attempt - 1)))
                    delay = base + int(self._retry_rng.random() * 0.5 * base)
                    self._retryq.append(
                        (int(time.monotonic() * 1e6) + delay, rec))
                    return
                rec["reply"] = body
                rec["end_us"] = int(time.monotonic() * 1e6)
                self.results.append(rec)

    def _flush_retries(self) -> None:
        """Resubmit QoS-nacked ops whose (jittered) retry_after elapsed,
        under fresh msg_ids; `start_us` is kept from the FIRST attempt so
        latency accounting includes the honored backoff."""
        if not self._retryq:
            return
        now = int(time.monotonic() * 1e6)
        due = [item for item in self._retryq if item[0] <= now]
        if not due:
            return
        self._retryq = [item for item in self._retryq if item[0] > now]
        for _, rec in due:
            self.qos_retries += 1
            self._msg_seq += 1
            msg_id = self._msg_seq
            rec["msg_id"] = msg_id
            self.pending[msg_id] = rec
            dest = self.names[msg_id % len(self.names)]
            body = {"type": "txn", "msg_id": msg_id, "txn": rec["ops"]}
            if rec.get("tenant"):
                body["tenant"] = rec["tenant"]
            if rec.get("priority"):
                body["priority"] = rec["priority"]
            self.procs[dest].send({"src": rec["client"], "dest": dest,
                                   "body": body})

    def pump(self, timeout: float = 0.05) -> int:
        handled = 0
        self._flush_retries()
        try:
            name, line = self.inbox.get(timeout=timeout)
        except queue.Empty:
            return 0
        while True:
            try:
                self._route(json.loads(line))
                handled += 1
            except json.JSONDecodeError:
                print(f"bad json from {name}: {line[:200]}", file=sys.stderr)
            try:
                name, line = self.inbox.get_nowait()
            except queue.Empty:
                return handled

    def pump_until(self, predicate, deadline_s: float = 60.0) -> bool:
        end = time.monotonic() + deadline_s
        while time.monotonic() < end:
            if predicate():
                return True
            self.pump()
        return predicate()

    # ------------------------------------------------------- crash-restart --
    def restart_node(self, name: str, deadline_s: float = 60.0) -> None:
        """Black-box crash-restart: SIGKILL the node process (no shutdown
        hook runs — true process death), respawn it with the same identity
        and environment, and re-init it.  With a journal_dir the replica
        replays its on-disk WAL before serving; without one this is a
        data-loss crash (useful as the negative control)."""
        hp = self.procs[name]
        hp.proc.kill()
        try:
            hp.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        self.init_acks.discard(name)
        self.procs[name] = HostProcess(name, self.inbox,
                                       extra_env=self._extra_env or None)
        self._msg_seq += 1
        self.procs[name].send({"src": "c0", "dest": name,
                               "body": {"type": "init",
                                        "msg_id": self._msg_seq,
                                        "node_id": name,
                                        "node_ids": self.names}})
        ok = self.pump_until(lambda: name in self.init_acks, deadline_s)
        assert ok, f"restarted {name} never re-initialized"

    # --------------------------------------------------------- admin plane --
    def install_epoch(self, epoch: int, shards, to: Optional[str] = None,
                      deadline_s: float = 30.0) -> dict:
        """Admin-plane epoch proposal over the Maelstrom transport:
        `shards` is [[start, end, [node_num, ...]], ...].  One contacted
        node journals the install before acking and gossips it to the rest
        (admin_epoch_ok carries the contact's post-install epoch)."""
        self._msg_seq += 1
        msg_id = self._msg_seq
        dest = to if to is not None else self.names[0]
        acked: List[dict] = []
        self.pending[msg_id] = {"msg_id": msg_id, "client": "c0",
                                "ops": [], "start_us": 0, "reply": None}
        self.procs[dest].send({
            "src": "c0", "dest": dest,
            "body": {"type": "admin_epoch", "msg_id": msg_id,
                     "topology": {
                         "epoch": int(epoch),
                         "shards": [[int(s), int(e),
                                     [int(n) for n in nodes]]
                                    for s, e, nodes in shards]}}})

        def got_ack() -> bool:
            rec = next((r for r in self.results
                        if r["msg_id"] == msg_id), None)
            if rec is not None:
                acked.append(rec)
            return bool(acked)

        ok = self.pump_until(got_ack, deadline_s)
        assert ok, f"admin_epoch {epoch} never acked by {dest}"
        rec = acked[0]
        self.results.remove(rec)
        assert rec["reply"]["type"] == "admin_epoch_ok", rec["reply"]
        return rec["reply"]

    def drain_node(self, name: str, deadline_s: float = 60.0) -> dict:
        """Admin-plane scale-in over the Maelstrom transport: ask `name` to
        drain — fence new client work, hand off in-flight coordinations,
        raise the GLOBAL_SYNC durability barrier — and wait for its
        admin_drain_ok (whose `durable` flag reports the barrier verdict)."""
        self._msg_seq += 1
        msg_id = self._msg_seq
        self.pending[msg_id] = {"msg_id": msg_id, "client": "c0",
                                "ops": [], "start_us": 0, "reply": None}
        self.procs[name].send({"src": "c0", "dest": name,
                               "body": {"type": "admin_drain",
                                        "msg_id": msg_id}})
        ok = self.pump_until(
            lambda: any(r["msg_id"] == msg_id for r in self.results),
            deadline_s)
        assert ok, f"admin_drain never acked by {name}"
        rec = next(r for r in self.results if r["msg_id"] == msg_id)
        self.results.remove(rec)
        assert rec["reply"]["type"] == "admin_drain_ok", rec["reply"]
        return rec["reply"]

    # ------------------------------------------------------------- client --
    def init_all(self) -> None:
        for name, hp in self.procs.items():
            self._msg_seq += 1
            hp.send({"src": "c0", "dest": name,
                     "body": {"type": "init", "msg_id": self._msg_seq,
                              "node_id": name, "node_ids": self.names}})
        # cold-starting N python processes (each importing jax) contends for
        # CPU; the deadline scales with cluster size
        ok = self.pump_until(
            lambda: len(self.init_acks) == len(self.names),
            30.0 + 15.0 * len(self.names))
        assert ok, f"init timed out: {sorted(self.init_acks)}"

    def submit_txn(self, client: str, ops: list, to: Optional[str] = None,
                   tenant: str = "", priority: str = "") -> int:
        self._msg_seq += 1
        msg_id = self._msg_seq
        dest = to if to is not None else \
            self.names[msg_id % len(self.names)]
        self.pending[msg_id] = {
            "msg_id": msg_id, "client": client, "ops": ops,
            "tenant": tenant, "priority": priority,
            "start_us": int(time.monotonic() * 1e6), "reply": None}
        body = {"type": "txn", "msg_id": msg_id, "txn": ops}
        if tenant:
            body["tenant"] = tenant
        if priority:
            body["priority"] = priority
        self.procs[dest].send({"src": client, "dest": dest, "body": body})
        return msg_id

    # ------------------------------------------------------------ workload --
    def run_workload(self, n_ops: int = 40, n_keys: int = 8,
                     pipeline: int = 4, deadline_s: float = 120.0,
                     single_key: bool = False) -> dict:
        """Randomized append/read mix; returns counters. Appended values are
        globally unique so the verifier can track per-key sequences.
        `single_key` restricts every txn to one key (the lin-kv shape);
        the default mixes multi-key RMWs (txn-rw-register)."""
        import random
        rng = random.Random(self.seed + self._next_value)
        submitted = [0]
        base = len(self.results)  # completions are counted per phase

        def submit_one():
            client = f"c{1 + rng.randrange(4)}"
            k = rng.randrange(n_keys)
            ops = [["r", k, None]]
            if rng.random() < 0.7:
                self._next_value += 1
                ops.append(["append", k, self._next_value])
            if not single_key and rng.random() < 0.3:
                k2 = rng.randrange(n_keys)
                if not any(o == "append" and ok == k2 for o, ok, _ in ops):
                    self._next_value += 1
                    ops.append(["append", k2, self._next_value])
            self.submit_txn(client, ops)
            submitted[0] += 1

        def completed() -> int:
            return len(self.results) - base

        for _ in range(min(pipeline, n_ops)):
            submit_one()
        end = time.monotonic() + deadline_s
        while completed() < n_ops and time.monotonic() < end:
            self.pump()
            while submitted[0] < n_ops \
                    and submitted[0] - completed() < pipeline:
                submit_one()
        ok = sum(1 for r in self.results[base:]
                 if r["reply"] and r["reply"].get("type") == "txn_ok")
        return {"submitted": submitted[0], "completed": completed(),
                "acked": ok}

    # -------------------------------------------------------------- verify --
    def final_histories(self, n_keys: int) -> Dict[int, tuple]:
        """Read every key through an ordinary linearizable read txn."""
        # drain in-flight txns first: a straggler acked after the final-read
        # snapshot would be verified against a state that predates it
        self.pump_until(lambda: not self.pending and not self._retryq, 30.0)
        for msg_id in list(self.pending):
            del self.pending[msg_id]  # never acked; late replies are ignored
        self._retryq.clear()  # a queued retry must not land past the snapshot
        ops = [["r", k, None] for k in range(n_keys)]
        msg_id = self.submit_txn("c9", ops, to=self.names[0])
        assert self.pump_until(
            lambda: any(r["msg_id"] == msg_id for r in self.results), 60.0), \
            "final read timed out"
        rec = next(r for r in self.results if r["msg_id"] == msg_id)
        assert rec["reply"]["type"] == "txn_ok", rec["reply"]
        self.results.remove(rec)
        return {key_token(k): tuple(v)
                for _, k, v in rec["reply"]["txn"]}

    def check_strict_serializability(self, n_keys: int) -> int:
        final = self.final_histories(n_keys)
        from accord_tpu_torch.sim.verify_replay import full_verifier
        verifier = full_verifier(witness_replay=False)
        checked = 0
        for rec in self.results:
            reply = rec["reply"]
            if not reply or reply.get("type") != "txn_ok":
                continue
            reads = {}
            appends = {}
            applied_so_far: Dict[int, int] = {}
            for op, k, v in reply["txn"]:
                token = key_token(k)
                if op == "r":
                    # the wire reply includes this txn's own earlier appends
                    # (Maelstrom txn-list-append semantics); the verifier's
                    # Observation wants the PRE-state read, so strip them
                    own = applied_so_far.get(token, 0)
                    reads[token] = tuple(v[:len(v) - own] if own else v)
                else:
                    appends[token] = v
                    applied_so_far[token] = applied_so_far.get(token, 0) + 1
            verifier.observe(Observation(
                f"txn{rec['msg_id']}", reads, appends,
                rec["start_us"], rec["end_us"]))
            checked += 1
        verifier.verify(final)
        return checked

    def close(self) -> None:
        for hp in self.procs.values():
            hp.close()


def main():
    import argparse
    ap = argparse.ArgumentParser(description="black-box maelstrom run")
    ap.add_argument("-n", "--nodes", type=int, default=3)
    ap.add_argument("-o", "--ops", type=int, default=40)
    ap.add_argument("-k", "--keys", type=int, default=8)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--pipeline", action="store_true",
                    help="continuous micro-batching ingest in every node "
                         "process (ACCORD_PIPELINE=1)")
    ns = ap.parse_args()
    runner = MaelstromRunner(ns.nodes, ns.seed, pipeline=ns.pipeline)
    try:
        t0 = time.monotonic()
        runner.init_all()
        stats = runner.run_workload(ns.ops, ns.keys)
        checked = runner.check_strict_serializability(ns.keys)
        dt = time.monotonic() - t0
        print(json.dumps({**stats, "verified_txns": checked,
                          "wall_s": round(dt, 2),
                          "txns_per_sec": round(stats["acked"] / dt, 1),
                          "ok": True}))
    finally:
        runner.close()


if __name__ == "__main__":
    main()
