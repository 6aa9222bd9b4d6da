"""The port's bounded-memory tier (``local/paging.py``, the spill store of
``journal/fault_index.py`` and the store's pager hooks) against the JAX
package's, on the CPU.

A seeded tape of spill-store operations runs through both packages' stores
side by side, and the zipfian open-loop run of ``tests/test_paging.py``
(300 ops over 4,000 keys, 25 resident commands a store, seed 17) runs
through both packages with the scalar stores and then with the device
stores (the port's on the CPU): reports, each node's paging stats, the
device counters and every store's final state are ``==``.  The settled-run
tests of ``tests/test_paging.py`` run on the port below, marked ``slow``
as the settled run takes a minute.
"""

import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

from accord_tpu_torch.workload import (open_loop_fingerprint, store_state,
                                       ts_tuple)

PACKAGES = ("accord_tpu", "accord_tpu_torch")
CAP = 25


def _modules(pkg):
    def imp(name):
        return importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(
        ls=imp("impl.list_store"), command=imp("local.command"),
        status=imp("local.status"), deps=imp("primitives.deps"),
        keys=imp("primitives.keys"), ts=imp("primitives.timestamp"),
        txn=imp("primitives.txn"), writes=imp("primitives.writes"),
        fi=imp("journal.fault_index"), wire=imp("host.wire"),
        frames=imp("messages.paging"), paging=imp("local.paging"),
        store=imp("local.store"), cluster=imp("sim.cluster"),
        device_store=imp("impl.device_store"),
        openloop=imp("workload.openloop"))


def _tid(m, hlc, node=1):
    return m.ts.TxnId.create(1, hlc, m.ts.TxnKind.WRITE, m.ts.Domain.KEY,
                             node)


def _applied_cmd(m, hlc):
    """``tests/test_paging.py``'s synthetic quiescent APPLIED command, built
    from package `m`'s modules."""
    Key, Keys, Range = m.keys.Key, m.keys.Keys, m.keys.Range
    t = _tid(m, hlc)
    keys = m.keys.RoutingKeys.of(1, 2)
    route = m.keys.Route(keys[0], keys=keys)
    txn = m.txn.Txn(m.ts.TxnKind.WRITE, Keys.of(1, 2),
                    read=m.ls.ListRead(Keys.of(1)), query=m.ls.ListQuery(),
                    update=m.ls.ListUpdate({Key(2): hlc}))
    ts = t.as_timestamp()
    cmd = m.command.Command(t)
    cmd.save_status = m.status.SaveStatus.APPLIED
    cmd.durability = m.status.Durability.NOT_DURABLE
    cmd.route = route
    cmd.partial_txn = txn.slice(route.covering(), include_query=True)
    cmd.execute_at = ts
    cmd.partial_deps = m.deps.Deps(
        m.deps.KeyDeps.of({Key(1): {_tid(m, hlc + 1000)}}),
        m.deps.RangeDeps.of({Range(0, 10): [_tid(m, hlc + 2000)]}))
    cmd.stable_deps = cmd.partial_deps
    cmd.writes = m.writes.Writes(t, ts, Keys.of(2),
                                 m.ls.ListWrite({Key(2): hlc}))
    cmd.result = m.ls.ListResult(t, ts, {Key(1): (4,)}, {Key(2): hlc})
    return cmd


def _spill_view(s):
    """A spill store's index and counters as plain data."""
    return ({ts_tuple(t): pos for t, pos in s.index.items()},
            s.frames_written, s.frames_faulted, s.frames_dropped,
            s.compactions, s.disk_bytes)


def test_spill_store_tape_matches_jax(tmp_path, monkeypatch):
    """One seeded tape of spills, supersedes, faults, drops, checkpoints,
    reopens (from a checkpoint and by a full scan) and compactions (the
    threshold lowered as ``tests/test_paging.py`` lowers it) through both
    packages' SpillStores: every result (a fault as its frame's wire
    bytes) and the index and counters after every operation are ==."""
    mods = [_modules(p) for p in PACKAGES]
    for m in mods:
        monkeypatch.setattr(m.fi, "COMPACT_MIN_BYTES", 1 << 12)
    dirs = [str(tmp_path / p) for p in PACKAGES]

    def open_store(m, d, fresh, every):
        return m.fi.SpillStore(d, fresh=fresh, segment_bytes=4096,
                               checkpoint_every=every)

    every = 8
    stores = [open_store(m, d, True, every) for m, d in zip(mods, dirs)]
    cmds = [{h: _applied_cmd(m, h) for h in range(10, 90)} for m in mods]
    rng = np.random.default_rng(7)
    done, compactions = set(), 0
    for step in range(600):
        op = rng.choice(["spill", "spill", "supersede", "fault", "fault",
                         "drop", "checkpoint", "reopen", "compact"],
                        p=[.2, .2, .1, .2, .15, .05, .04, .04, .02])
        live = sorted(h for h in cmds[0]
                      if _tid(mods[0], h) in stores[0].index)
        if op in ("supersede", "fault") and not live:
            op = "spill"
        got = []
        if op == "reopen":
            final, every = bool(rng.integers(2)), int(rng.choice([0, 8]))
            compactions += stores[0].compactions
            for i, (m, d) in enumerate(zip(mods, dirs)):
                stores[i].close(final_checkpoint=final)
                stores[i] = open_store(m, d, False, every)
            op = f"reopen final_checkpoint={final}"
        elif op in ("checkpoint", "compact"):
            for s in stores:
                got.append(getattr(s, op)())
        else:
            h = int(rng.choice(live)) if op in ("supersede", "fault") \
                else int(rng.integers(10, 90))
            for m, s, c in zip(mods, stores, cmds):
                if op == "fault":
                    back = s.fault(_tid(m, h))
                    got.append(m.wire.encode_message(
                        m.frames.SpillFrame.from_command(back)))
                elif op == "drop":
                    got.append(s.drop(_tid(m, h)))
                else:
                    if op == "supersede":
                        c[h].durability = m.status.Durability.UNIVERSAL
                    got.append(s.spill(c[h]))
        done.add(op.split()[0] if not op.startswith("reopen") else op)
        assert got[:1] == got[1:], (step, op)
        assert _spill_view(stores[1]) == _spill_view(stores[0]), (step, op)
    for s in stores:
        s.close()
    assert compactions + stores[0].compactions > 0
    assert {"spill", "supersede", "fault", "drop", "checkpoint",
            "reopen final_checkpoint=True",
            "reopen final_checkpoint=False"} <= done, done


def _pager_state(cluster):
    """Every store's resident state (``store_state``), its spilled ids and
    its paged-out CFK shells."""
    out = []
    for _nid, node in sorted(cluster.nodes.items()):
        for store in node.command_stores.all():
            pager = store.pager
            out.append((store_state(store),
                        sorted(map(ts_tuple, pager.spilled)),
                        sorted(k.token for k in pager.cfk_residuals)))
    return out


def _open_loop(m, factory):
    run = m.openloop.run_open_loop_sim(
        profile="zipfian", ops=300, rate_per_s=300.0, keys=4000,
        token_span=4000, seed=17, store_factory=factory, keep_cluster=True)
    return (run.report, open_loop_fingerprint(run, m.paging.node_paging_stats),
            _pager_state(run.cluster))


def test_open_loop_paging_matches_jax(monkeypatch):
    """Paging off keeps the plain dict in both packages; with 25 resident
    commands a store, the open-loop run of ``tests/test_paging.py`` gives
    the same report, paging stats, device counters and final store state
    in both packages, with the scalar stores and with the device stores
    (300 µs windows, verify on; the port's on the CPU)."""
    mods = [_modules(p) for p in PACKAGES]
    monkeypatch.delenv("ACCORD_RESIDENT_CMDS", raising=False)
    monkeypatch.delenv("ACCORD_RESIDENT_BYTES", raising=False)
    for m in mods:
        cluster = m.cluster.SimCluster(n_nodes=3, seed=1)
        for node in cluster.nodes.values():
            for store in node.command_stores.all():
                assert store.pager is None
                assert type(store.commands) is dict
            assert m.paging.node_paging_stats(node) is None

    monkeypatch.setenv("ACCORD_RESIDENT_CMDS", str(CAP))
    jax_m, port_m = mods
    for kind in ("scalar", "device"):
        if kind == "scalar":
            factories = (None, None)
        else:
            factories = (jax_m.device_store.DeviceCommandStore.factory(
                flush_window_us=300, verify=True),
                port_m.device_store.DeviceCommandStore.factory(
                flush_window_us=300, verify=True, device="cpu"))
        want = _open_loop(jax_m, factories[0])
        got = _open_loop(port_m, factories[1])
        assert got[0] == want[0], kind
        assert got[1] == want[1], kind
        assert got[2] == want[2], kind
        fp = want[1]
        assert fp["counts"]["acked"] == 300, fp["counts"]
        assert all(n["paging"]["evictions"] > 0
                   for n in fp["nodes"].values()), fp
        if kind == "device":
            assert all(n["device"]["device_hits"] > 0
                       and not n["device"]["device_disabled"]
                       for n in fp["nodes"].values()), fp


# ------------------------------------- tests/test_paging.py on the port ----

@pytest.fixture(scope="module")
def settled_run():
    """``tests/test_paging.py``'s settled run on the port: the open-loop run
    above with the scalar stores, then 15 s of virtual time to settle."""
    from accord_tpu_torch.workload import run_open_loop_sim
    prev = os.environ.get("ACCORD_RESIDENT_CMDS")
    os.environ["ACCORD_RESIDENT_CMDS"] = str(CAP)
    try:
        run = run_open_loop_sim(profile="zipfian", ops=300,
                                rate_per_s=300.0, keys=4000,
                                token_span=4000, seed=17,
                                keep_cluster=True)
    finally:
        if prev is None:
            os.environ.pop("ACCORD_RESIDENT_CMDS", None)
        else:
            os.environ["ACCORD_RESIDENT_CMDS"] = prev
    cluster = run.cluster
    end_s = cluster.now_s + 15.0
    cluster.process_until(lambda: cluster.now_s >= end_s,
                          max_items=50_000_000)
    return run


def _pagers(cluster):
    for node in cluster.nodes.values():
        for store in node.command_stores.all():
            if store.pager is not None:
                yield store, store.pager


@pytest.mark.slow
class TestPagerIntegration:
    def test_budget_enforced_protocol_blind(self, settled_run):
        counts = settled_run.report["counts"]
        assert counts["pending"] == 0 and counts["failed"] == 0, counts
        assert counts["acked"] == 300, counts
        engaged = 0
        for _store, pager in _pagers(settled_run.cluster):
            s = pager.stats()
            assert s["resident"] <= CAP, s
            if s["evictions"]:
                engaged += 1
                assert s["spill_disk_bytes"] > 0
                assert s["refaults"] > 0 or s["spilled"] > 0
        assert engaged > 0, "no store's budget ever forced an eviction"

    def test_refault_then_truncate_ordering(self, settled_run):
        from accord_tpu_torch.local import commands as C
        from accord_tpu_torch.local.status import SaveStatus
        from accord_tpu_torch.local.store import (PreLoadContext,
                                                  SafeCommandStore)
        store = pager = txn_id = None
        for st, pg in _pagers(settled_run.cluster):
            for cand, meta in pg.meta.items():
                if meta[2] == "applied":
                    store, pager, txn_id = st, pg, cand
                    break
            if txn_id is not None:
                break
        assert txn_id is not None, "no spilled APPLIED command to test with"

        cmd = store.commands[txn_id]            # forced refault
        assert cmd.save_status == SaveStatus.APPLIED
        assert txn_id not in pager.spilled
        assert txn_id not in pager.spill_store().index

        safe = SafeCommandStore(store, PreLoadContext.empty())
        C.purge(safe, txn_id, erase=False, keep_outcome=True)
        truncated = store.commands[txn_id]      # resident, no fault
        assert truncated.save_status == SaveStatus.TRUNCATED_APPLY

        pager._evict(txn_id, truncated)         # re-spill current state
        assert txn_id in pager.spilled
        back = store.commands[txn_id]           # refault again
        assert back.save_status == SaveStatus.TRUNCATED_APPLY

    def test_cfk_shells_evict_and_restore(self, settled_run):
        store = pager = key = None
        for st, pg in _pagers(settled_run.cluster):
            if pg.cfk_evictions and pg.cfk_residuals:
                store, pager = st, pg
                key = next(iter(pg.cfk_residuals))
                break
        assert key is not None, "settle never paged out an empty CFK shell"
        redundant_before, version, committed = pager.cfk_residuals[key]
        assert key not in store.cfks
        assert store._cfk_tokens.count(key.token) == 1

        restores_before = pager.cfk_restores
        cfk = store._cfk(key)
        assert pager.cfk_restores == restores_before + 1
        assert key not in pager.cfk_residuals
        assert store.cfks[key] is cfk
        assert cfk.redundant_before == redundant_before
        assert cfk.version == version
        assert cfk.committed_version == committed
        assert store._cfk_tokens.count(key.token) == 1

    def test_census_counts_spilled_and_eviction_is_count_neutral(
            self, settled_run):
        from accord_tpu_torch.local.audit import (_QUIESCENT_UNCLEANED,
                                                  census_node)
        cluster = settled_run.cluster
        node = next(n for n in cluster.nodes.values()
                    for _s, p in _pagers(cluster) if p.evictions)
        census = census_node(node)
        assert census["spilled"] > 0
        assert census["paging"] is not None
        assert sum(census["spilled_by_class"].values()) == census["spilled"]

        store, pager = next((s, p) for s, p in _pagers(cluster)
                            if s.node is node)
        victim = next(
            (tid for tid, cmd in list(store.commands.items())
             if cmd.save_status in _QUIESCENT_UNCLEANED
             and not cmd.listeners and not cmd.transient_listeners
             and tid not in store.gated and not tid.is_range_domain
             and tid not in store.range_commands), None)
        assert victim is not None
        before = census_node(node)
        pager._evict(victim, store.commands[victim])
        after = census_node(node)
        assert after["quiescent_uncleaned"] == before["quiescent_uncleaned"]
        assert after["spilled"] == before["spilled"] + 1
        assert after["resident"] == before["resident"] - 1

    def test_census_gauges_publish_spilled_tier(self, settled_run):
        cluster = settled_run.cluster
        cluster.attach_auditors(interval_s=0.0)
        total = 0
        for a in cluster.auditors.values():
            census = a.census_once()
            assert not census["leak_alarm"]
            for cls, n in census["spilled_by_class"].items():
                got = a.registry.value("accord_census_commands",
                                       node=census["node"], cls=cls,
                                       tier="spilled")
                assert got == n
                total += n
            assert a.registry.value("accord_pager_evictions",
                                    node=census["node"]) \
                == census["paging"]["evictions"]
        assert total > 0, "no spilled state visible in any census"


def _with_cap(cap):
    prev = os.environ.get("ACCORD_RESIDENT_CMDS")
    os.environ["ACCORD_RESIDENT_CMDS"] = str(cap)

    def restore():
        if prev is None:
            os.environ.pop("ACCORD_RESIDENT_CMDS", None)
        else:
            os.environ["ACCORD_RESIDENT_CMDS"] = prev
    return restore


@pytest.mark.slow
class TestPagingBurns:
    def test_differential_burn_paging_on_off_bit_identical(self):
        from accord_tpu_torch.local.paging import node_paging_stats
        from accord_tpu_torch.sim.burn import BurnRun

        def arm():
            r = BurnRun(23, ops=60, nodes=3, keys=10)
            stats = r.run()
            snaps = {n: r.cluster.node(n).data_store.snapshot()
                     for n in r.cluster.nodes}
            return stats, snaps, r.audit_rounds, r.cluster

        assert "ACCORD_RESIDENT_CMDS" not in os.environ
        stats_off, snaps_off, audit_off, _ = arm()
        restore = _with_cap(6)
        try:
            stats_on, snaps_on, audit_on, cluster_on = arm()
        finally:
            restore()
        assert (stats_on.acks, stats_on.nacks, stats_on.shed,
                stats_on.lost) == (stats_off.acks, stats_off.nacks,
                                   stats_off.shed, stats_off.lost)
        assert snaps_on == snaps_off
        assert audit_on == audit_off
        per_node = [node_paging_stats(cluster_on.node(n))
                    for n in cluster_on.nodes]
        assert all(p is not None for p in per_node)
        assert sum(p["evictions"] for p in per_node) > 0

    def test_crash_restart_burn_with_paging(self):
        from accord_tpu_torch.local.paging import node_paging_stats
        from accord_tpu_torch.sim.burn import BurnRun
        restore = _with_cap(6)
        try:
            r = BurnRun(31, ops=80, nodes=3, keys=10, restarts=1)
            stats = r.run()
        finally:
            restore()
        assert stats.restarts == 1
        assert stats.acks > 0 and stats.lost == 0, stats
        assert r.journal_checked > 0
        per_node = [node_paging_stats(r.cluster.node(n))
                    for n in r.cluster.nodes]
        assert all(p is not None for p in per_node)
        assert sum(p["evictions"] for p in per_node) > 0
