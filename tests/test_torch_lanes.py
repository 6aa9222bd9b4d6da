"""The bench lanes over real node processes and the shard workers, on the
CPU, with every command store a ``DeviceCommandStore`` there.

Every test here starts processes, opens sockets or reads the wall clock, so
every one is ``slow``:

* each lane of ``accord_tpu_torch.bench`` that the JAX ``bench.py`` runs
  over node processes keeps its JAX verdicts (the lane raises otherwise),
  and every node process or shard worker served its flushes from
  ``DeviceCommandStore``s on the CPU with deps flushes > 0 and holds off
  full collections (``bench.check_per_node``); the host-only lanes keep
  theirs;
* the open-loop TCP runners draw the JAX runners' op lists and arrival
  offsets for the same seed (a recording client stands in for the
  cluster);
* the shard workers behind device stores: the JAX package's in-loop
  against workers parity test (``tests/test_shard_workers.py``) on the
  port, with each worker's device evidence read from the node's metrics;
* a range command that ends at the real-socket host's span end (2**31)
  keeps the port's store on its device tier, where the JAX store's int32
  encoding overflows;
* a 1.5 s stall of one node's flush under the 1 s RPC timeout, in both
  packages: every client is answered.
"""

import importlib
import os
import random
import time
from collections import Counter

import pytest

import bench as jax_bench
from accord_tpu_torch import bench

pytestmark = pytest.mark.slow

PACKAGES = ("accord_tpu", "accord_tpu_torch")
BAD_STDERR = ("Traceback", "uncaught:", "handled:")


def _no_agent_errors(capfd):
    err = capfd.readouterr().err
    for bad in BAD_STDERR:
        assert bad not in err, err[-4000:]


# ------------------------------------------------------------ the lanes --

@pytest.mark.parametrize("config", ["pipeline", "slo-tcp", "ephemeral",
                                    "slo-journal", "slo-reshard",
                                    "slo-overload"])
def test_device_store_lane_on_cpu(config, monkeypatch, capfd):
    monkeypatch.setenv("ACCORD_PROFILE", "1")
    out = bench.LANES[config](device="cpu")
    _no_agent_errors(capfd)
    assert out["device"] == "cpu" and out["value"] is None
    rows = out["per_node"]
    # the reshard lane: founders 1-3 (1 retired, its row taken before) and
    # the joiner 4
    want = [1, 2, 3, 4] if config == "slo-reshard" else [1, 2, 3]
    assert sorted(r["node"] for r in rows) == want
    bench.check_per_node(rows, "cpu")
    if config == "pipeline":
        assert out["widest_flush_window_txns"] > 1
    if config == "slo-overload":
        assert all(out["verdicts"].values())


def test_multicore_lane_on_cpu(monkeypatch, capfd):
    """The JAX lane's keys 0-49 are tokens in the first worker's slice of
    the span: the other workers build their stores and take no traffic."""
    monkeypatch.setenv("ACCORD_PROFILE", "1")
    out = bench.LANES["multicore"](device="cpu")
    _no_agent_errors(capfd)
    assert out["shards"] == [1, 2, 4] and out["cpus_available"] >= 1
    for n, row in out["per_shards"].items():
        n = int(n)
        assert row["acked"] > 180 and row["workers_with_keys"] == [0]
        bench.check_per_node(row["per_node"], "cpu",
                             workers=n if n >= 2 else 0,
                             idle=set(range(1, n)))


def test_multicore_lane_spread_keys_on_cpu(monkeypatch, capfd):
    """Keys spread over the span reach every worker's device store."""
    from accord_tpu_torch.host.maelstrom import TOKEN_SPAN
    monkeypatch.setenv("ACCORD_PROFILE", "1")
    out = bench.multicore_lane(device="cpu", shards_list=(4,),
                               key_stride=TOKEN_SPAN // 50)
    _no_agent_errors(capfd)
    row = out["per_shards"]["4"]
    assert row["workers_with_keys"] == [0, 1, 2, 3]
    bench.check_per_node(row["per_node"], "cpu", workers=4)


@pytest.mark.parametrize("config", ["journal", "maelstrom", "maelstrom-rw"])
def test_host_lane(config):
    out = bench.LANES[config]()
    assert out["device"] == "host"
    if config == "journal":
        assert out["appends"] == 20000 and out["fsyncs_group"] > 0
    else:
        assert out["verified"] == "strict-serializable"
        assert out["acked"] > 360


# ------------------------------------------- op lists and arrivals == JAX --

class _Recorder:
    """A stand-in for ``TcpClusterClient``: records every submit and acks
    it at once."""

    def __init__(self, n_nodes=3, n_shards=4, **_):
        self.submits, self._replies = [], []

    def submit(self, to, reads, appends, req, ephemeral=False,
               want_phases=False, tenant="", priority=""):
        self.submits.append((to, tuple(reads), sorted(appends.items()),
                             req, ephemeral, tenant, priority))
        self._replies.append({"body": {"type": "submit_reply", "req": req,
                                       "ok": True, "reads": {}}})

    def recv(self, timeout_s=30.0):
        if self._replies:
            return self._replies.pop(0)
        time.sleep(min(timeout_s, 0.005))
        return None

    def fetch_metrics(self, to, timeout_s=15.0):
        return None

    def close(self):
        pass


class _Stop(Exception):
    pass


def _drawn(pkg, monkeypatch, runner, client_cls, **kwargs) -> dict:
    """`runner` of `pkg`'s openloop module with `client_cls` as its
    cluster client -> the arrival offsets and ops it drew, and the
    submits the client saw."""
    ol = importlib.import_module(f"{pkg}.workload.openloop")
    tcp = importlib.import_module(f"{pkg}.host.tcp")
    seen = {"offsets": [], "ops": [], "submits": None}
    real_offsets, real_profile = ol.make_offsets_us, ol.make_profile

    def offsets(*a, **k):
        out = real_offsets(*a, **k)
        seen["offsets"].append(list(out))
        return out

    def profile(*a, **k):
        prof = real_profile(*a, **k)
        draw = prof.next_op

        def next_op():
            op = draw()
            seen["ops"].append((tuple(op.reads), sorted(op.appends.items()),
                                op.ephemeral))
            return op
        prof.next_op = next_op
        return prof

    def client(*a, **k):
        c = client_cls(*a, **k)
        seen["submits"] = getattr(c, "submits", None)
        return c

    monkeypatch.setattr(ol, "make_offsets_us", offsets)
    monkeypatch.setattr(ol, "make_profile", profile)
    monkeypatch.setattr(tcp, "TcpClusterClient", client)
    try:
        getattr(ol, runner)(**kwargs)
    except _Stop:
        pass
    return seen


def _stop(*_, **__):
    raise _Stop


@pytest.mark.parametrize("runner,client,kwargs", [
    ("run_open_loop_tcp", _Recorder,
     dict(profile="zipfian", ops=400, rate_per_s=80.0, keys=64, seed=7)),
    ("run_open_loop_tcp", _Recorder,
     dict(profile="ephemeral_read_heavy", ops=400, rate_per_s=100.0,
          keys=64, seed=7)),
    # the reshard runner draws its whole schedule before it starts a node
    ("run_reshard_tcp", _stop,
     dict(ops=2400, rate_per_s=80.0, reshard_at_frac=0.33, seed=13)),
    # the overload lane's seed and anchor, its windows cut to 0.3 s
    ("run_overload_tcp", _Recorder,
     dict(seed=23, capacity_per_s=120.0, window_s=0.3, gap_s=0.0)),
])
def test_open_loop_runners_draw_the_jax_schedule(runner, client, kwargs,
                                                 monkeypatch):
    want = _drawn("accord_tpu", monkeypatch, runner, client, **kwargs)
    got = _drawn("accord_tpu_torch", monkeypatch, runner, client, **kwargs)
    assert got["offsets"] and got["ops"]
    assert got["offsets"] == want["offsets"]
    assert got["ops"] == want["ops"]
    assert got["submits"] == want["submits"]


def test_slo_lanes_are_the_jax_lanes_arguments(monkeypatch):
    """Each open-loop lane calls its runner with the JAX lane's arguments,
    and its node processes would see the JAX lane's pipeline and QoS
    settings."""
    calls = {}
    # the node settings the JAX lanes put in os.environ: restored after
    node_keys = ("ACCORD_PIPELINE", "ACCORD_PIPELINE_MAX_BATCH",
                 "ACCORD_PIPELINE_MAX_WAIT_US", *bench.OVERLOAD_QOS_ENV)
    for k in node_keys:
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)

    def fake(name):
        def run(**kwargs):
            env = {k: os.environ.get(k)
                   for k in node_keys}
            calls.setdefault(name, []).append((kwargs, env))
            raise _Stop
        return run

    for pkg_mod in (importlib.import_module("accord_tpu.workload"),
                    importlib.import_module("accord_tpu.workload.openloop"),
                    importlib.import_module("accord_tpu_torch.workload"),
                    importlib.import_module(
                        "accord_tpu_torch.workload.openloop")):
        for name in ("run_open_loop_tcp", "run_reshard_tcp",
                     "run_overload_tcp"):
            if hasattr(pkg_mod, name):
                monkeypatch.setattr(pkg_mod, name, fake(name))
    monkeypatch.setattr(jax_bench, "emit", lambda r: None)
    for k in ("ACCORD_SLO_OPS", "ACCORD_SLO_RATE", "ACCORD_RESHARD_AT",
              "ACCORD_OVERLOAD_WINDOW_S", "ACCORD_OVERLOAD_CAPACITY",
              "ACCORD_JOURNAL"):
        monkeypatch.delenv(k, raising=False)
    for jax_call, config in (
            (lambda: jax_bench.bench_slo_tcp("slo-tcp", "zipfian", ops=400,
                                             rate_per_s=80.0), "slo-tcp"),
            (lambda: jax_bench.bench_slo_tcp(
                "ephemeral", "ephemeral_read_heavy", ops=400,
                rate_per_s=100.0), "ephemeral"),
            (jax_bench.bench_slo_reshard, "slo-reshard"),
            (jax_bench.bench_slo_overload, "slo-overload")):
        calls.clear()
        with pytest.raises(_Stop):
            jax_call()
        want = dict(calls)
        calls.clear()
        with pytest.raises(_Stop):
            bench.LANES[config](device="cpu")
        assert calls == want, config


# ------------------------------------------ the shard workers (item 15) --

class _TransientNack(AssertionError):
    """A submit was nacked (a coordination timeout under CPU contention):
    the append may have applied, so the mode reruns on a fresh cluster."""


def _drain_replies(client, want: int, timeout_s: float = 60.0) -> dict:
    got = {}
    deadline = time.time() + timeout_s
    while len(got) < want and time.time() < deadline:
        m = client.recv(timeout_s=5.0)
        if m and m["body"].get("type") == "submit_reply":
            body = m["body"]
            if not body["ok"]:
                raise _TransientNack(str(body))
            got[body["req"]] = body
    assert len(got) == want, f"only {len(got)}/{want} replies"
    return got


def _workload(client, tokens, appends_per_token: int) -> int:
    req = 0
    for rnd in range(appends_per_token):
        for i, tok in enumerate(tokens):
            client.submit(1 + (req % 3), [], {tok: rnd * 1000 + i}, req=req)
            _drain_replies(client, 1)
            req += 1
    return req


def _final_reads(client, tokens, req0: int) -> dict:
    req = req0
    out = {}
    for tok in tokens:
        client.submit(1 + (req % 3), [tok], {}, req=req)
        req += 1
        for body in _drain_replies(client, 1).values():
            for t, vals in body["reads"].items():
                out[int(t)] = list(vals)
    return out


# the JAX test's tokens (all in the first of two workers' slices of the
# 2**31 span), and the same spread over the span so both workers serve
REFERENCE_TOKENS = [3, 117, 250, 399, 512, 731, 888]
SPREAD_TOKENS = [t << 21 for t in REFERENCE_TOKENS]


@pytest.mark.parametrize("tokens", [REFERENCE_TOKENS, SPREAD_TOKENS],
                         ids=["reference-tokens", "spread-tokens"])
def test_differential_parity_inloop_vs_workers_device_stores(
        tokens, monkeypatch, capfd):
    """``tests/test_shard_workers.py::test_differential_parity_inloop_vs_
    workers`` on the port with every store a DeviceCommandStore on the CPU:
    the same workload against an in-loop cluster and a 2-worker-a-node
    cluster gives the same per-key histories, the sharded cluster's audit
    agrees, and every worker of every node built its stores on the CPU
    and shows its deps flushes, laps and launches in its node's metrics
    (each owning worker with deps flushes > 0)."""
    from accord_tpu_torch.host.tcp import TcpClusterClient

    monkeypatch.setenv("ACCORD_TCP_DEVICE_STORE", "1")
    monkeypatch.setenv("ACCORD_TCP_DEVICE", "cpu")
    monkeypatch.setenv("ACCORD_PROFILE", "1")
    finals = {}
    for mode, shards in (("inloop", None), ("workers", "2")):
        if shards is None:
            monkeypatch.delenv("ACCORD_SHARDS", raising=False)
        else:
            monkeypatch.setenv("ACCORD_SHARDS", shards)
        monkeypatch.setenv("ACCORD_AUDIT_S", "2")
        for attempt in range(3):
            c = TcpClusterClient(n_nodes=3, n_shards=4)
            try:
                if mode == "workers":
                    # a worker routed a submit before it is live holds it
                    # past the 1 s RPC timeout: it warms its store first
                    bench.wait_workers_live(c, nodes=(1, 2, 3))
                try:
                    n = _workload(c, tokens, appends_per_token=3)
                    finals[mode] = _final_reads(c, tokens, n)
                except _TransientNack:
                    if attempt == 2:
                        raise
                    continue
                if mode == "workers":
                    _check_workers(c, tokens)
                break
            finally:
                c.close()
    _no_agent_errors(capfd)
    assert finals["inloop"] == finals["workers"], finals


def _check_workers(c, tokens) -> None:
    # shards view: every node runs 2 live workers, gen 1
    c._send(1, {"type": "shards", "req": 9001})
    rows = None
    deadline = time.time() + 20
    while rows is None and time.time() < deadline:
        m = c.recv(timeout_s=5.0)
        if m and m["body"].get("type") == "shards_reply":
            rows = m["body"]["shards"]
    assert rows is not None and len(rows) == 2, rows
    assert all(r["live"] for r in rows), rows
    # cross-replica audit over merged worker digests
    report = None
    deadline = time.time() + 30
    while time.time() < deadline:
        c._send(2, {"type": "audit", "req": 9002})
        m = c.recv(timeout_s=5.0)
        view = (m["body"].get("audit")
                if m and m["body"].get("type") == "audit_reply" else None)
        if view and view.get("last_report") \
                and view["last_report"]["rounds"]:
            report = view
            outcomes = {r["outcome"] for r in view["last_report"]["rounds"]}
            if outcomes == {"agree"}:
                break
        time.sleep(1.0)
    assert report is not None, "no audit round completed"
    assert not report["divergences"], report["divergences"]
    assert {r["outcome"] for r in report["last_report"]["rounds"]} == \
        {"agree"}
    # each worker's device evidence, from a stats poll after the traffic
    time.sleep(bench.WORKER_STATS_WAIT_S)
    owning = bench._workers_owning(tokens, 2)
    for nid in (1, 2, 3):
        rows = bench.per_node_rows([c.fetch_metrics(nid)])
        assert {r["node"] for r in rows} == {nid}
        bench.check_per_node(rows, "cpu", workers=2,
                             idle=set(range(2)) - set(owning))


# ------------------------------------- range bounds at the span's end --

def test_range_bounds_at_the_top_of_the_token_span():
    """A store plan's tokens moved up so the last key is 2**31 - 1 and range
    commands end past it, as at the real-socket host's span end (2**31).
    The port's store, verify on (every served scan checked against the
    scalar scan), stays on its device tier and gives, token for token, the
    JAX store's results and counters on the plan as drawn; the JAX store's
    int32 encoding overflows on the moved plan."""
    from accord_tpu.impl.device_store import \
        DeviceCommandStore as JaxDeviceCommandStore
    from accord_tpu_torch.impl.device_store import DeviceCommandStore
    from accord_tpu_torch.workload import (STORE_KIT_MODULES, StoreNode,
                                           StorePlanRunner, device_counters,
                                           store_kit, store_plan)

    n_keys = 24
    shift = (1 << 31) - 1 - 10 * (n_keys - 1)
    mix = (("preaccept", 0.40), ("accept", 0.05), ("commit", 0.15),
           ("apply", 0.15), ("recover", 0.05), ("range", 0.20))
    plan = store_plan(4, n_keys=n_keys, n_txns=240, mix=mix)

    def moved_up(parts):
        return tuple((p[0] + shift, p[1] + shift) if isinstance(p, tuple)
                     else p + shift for p in parts)

    moved = ([(kind, domain, hlc, node, moved_up(parts))
              for kind, domain, hlc, node, parts in plan[0]], plan[1])
    assert max(e for *_, parts in moved[0] for p in parts
               if isinstance(p, tuple) for e in p) > (1 << 31)

    def moved_down(x):
        """A result with its tokens (the only ints past 2**30) moved back."""
        if isinstance(x, tuple):
            return tuple(moved_down(v) for v in x)
        if isinstance(x, list):
            return [moved_down(v) for v in x]
        return x - shift if isinstance(x, int) and x >= 1 << 30 else x

    def runner(kit, factory, plan, lo):
        node = StoreNode(kit)
        store = factory(0, node, kit.Ranges.of((lo, lo + 10 * n_keys + 100)))
        return StorePlanRunner(store, node, plan)

    jax_kit = store_kit({n: importlib.import_module("accord_tpu." + n)
                         for n in STORE_KIT_MODULES})
    port = runner(store_kit(), DeviceCommandStore.factory(
        verify=True, device="cpu"), moved, shift - 10)
    ref = runner(jax_kit, JaxDeviceCommandStore.factory(verify=True), plan,
                 -10)
    for w, ops in enumerate(plan[1]):
        assert moved_down(port.run_window(ops)) == ref.run_window(ops), \
            f"window {w}"
        assert device_counters(port.store) == device_counters(ref.store), \
            f"window {w}"
    assert not port.store.device_disabled
    assert device_counters(port.store)["device_range_batches"] > 0

    overflowing = runner(jax_kit, JaxDeviceCommandStore.factory(verify=True),
                         moved, shift - 10)
    with pytest.raises(OverflowError):
        for ops in plan[1]:
            overflowing.run_window(ops)


# ------------------------------------------ the 1 s RPC timeout, settled --

def _stalled_cluster_run(pkg, monkeypatch, n_txns=90, keys=20, depth=16,
                         stall_at=30, stall_s=1.5, seed=4) -> dict:
    """Three in-process TcpHosts of `pkg`, every store a DeviceCommandStore
    on the CPU, the default 1 s RPC timeout; node 2's store stalls one
    flush for `stall_s` once `stall_at` txns are in.  `n_txns` single-key
    appends, `depth` in flight, each awaited up to 60 s -> the outcomes
    and the coordination rounds whose replies timed out."""
    tcp = importlib.import_module(f"{pkg}.host.tcp")
    ds = importlib.import_module(f"{pkg}.impl.device_store")
    node_mod = importlib.import_module(f"{pkg}.local.node")
    monkeypatch.setenv("ACCORD_TCP_DEVICE_STORE", "1")
    monkeypatch.setenv("ACCORD_TCP_DEVICE", "cpu")
    monkeypatch.delenv("ACCORD_HOST_RPC_TIMEOUT_S", raising=False)
    for k in ("ACCORD_SHARDS", "ACCORD_PIPELINE", "ACCORD_QOS",
              "ACCORD_JOURNAL"):
        monkeypatch.delenv(k, raising=False)
    armed = {"left": 0, "fired": 0}
    precompute = ds.DeviceCommandStore._precompute

    def stalled(self, window):
        if armed["left"] and self.node.id == 2:
            armed["left"] -= 1
            armed["fired"] += 1
            time.sleep(stall_s)
        return precompute(self, window)

    rounds = Counter()
    on_timeout = node_mod._SafeCallback._on_timeout

    def timed_out(self):
        if not self.done:
            rounds[type(self.callback).__name__] += 1
        return on_timeout(self)

    monkeypatch.setattr(ds.DeviceCommandStore, "_precompute", stalled)
    monkeypatch.setattr(node_mod._SafeCallback, "_on_timeout", timed_out)
    ports = {1: ("127.0.0.1", 0), 2: ("127.0.0.1", 0), 3: ("127.0.0.1", 0)}
    hosts = {}
    rng = random.Random(seed)
    outcomes = Counter()
    try:
        for i in (1, 2, 3):
            hosts[i] = tcp.TcpHost(i, ports)
            ports = dict(hosts[i].peers)
        for h in hosts.values():
            h.peers.update(ports)
        pending = []

        def settle(result):
            result.wait(60.0)
            f = result.failure
            outcomes["ok" if f is None else
                     "unanswered" if isinstance(f, TimeoutError)
                     and str(f) == "txn did not complete"
                     else type(f).__name__] += 1

        for i in range(n_txns):
            if i == stall_at:
                armed["left"] = 1
            k = rng.randrange(keys)
            pending.append(hosts[1 + i % 3].submit([k], {k: i + 1}))
            while len(pending) >= depth:
                settle(pending.pop(0))
        for r in pending:
            settle(r)
    finally:
        for h in hosts.values():
            h.close()
    return {"stalls": armed["fired"], "outcomes": outcomes,
            "rounds": rounds}


def test_one_second_rpc_timeout_answers_every_client_in_both_packages(
        monkeypatch):
    """One node's flush stalls 1.5 s under the 1 s default RPC timeout:
    in both packages the stalled replica's PreAccept replies time out
    (CoordinateTransaction), and a txn may fail with Timeout when its
    execute round (ExecutePath) times out on a hot key; but every client
    is answered, in the port as in the reference."""
    runs = {pkg: _stalled_cluster_run(pkg, monkeypatch) for pkg in PACKAGES}
    for pkg, run in runs.items():
        assert run["stalls"] == 1, (pkg, run)
        assert run["outcomes"]["unanswered"] == 0, (pkg, run)
        assert sum(run["outcomes"].values()) == 90, (pkg, run)
        assert run["rounds"]["CoordinateTransaction"] > 0, (pkg, run)
        assert set(run["rounds"]) <= {"CoordinateTransaction",
                                      "ExecutePath"}, (pkg, run)
