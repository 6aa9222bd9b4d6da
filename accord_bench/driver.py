"""The store driver: one replica's command store fed the lifecycle's ops.

``QueueScheduler``, ``StoreNode`` and ``LifecycleRunner`` are frozen copies
of ``QueueScheduler``, ``StoreNode``, ``store_kit`` and ``StorePlanRunner``
in ``accord_tpu_torch/workload/worlds.py`` at commit f0ab6b5, cut to the
ops the lifecycle sends (PreAccept, Accept, stable Commit, Apply) over
key-domain transactions and range-domain READs, with two additions: the
node's events listener records the host time at which each transaction
applied, and its data store logs the order in which writes run.  Each op
is built from the generated plain data with the program's own classes;
its reply is kept as plain tuples.
"""

from __future__ import annotations

import collections
import time
from contextlib import nullcontext
from types import SimpleNamespace
from typing import Dict, List, Optional


def store_kit() -> SimpleNamespace:
    """The program's classes the driver builds ops and a node from."""
    from accord_tpu_torch.api import spi
    from accord_tpu_torch.impl import list_store as ls
    from accord_tpu_torch.local import commands as cmds
    from accord_tpu_torch.local import status, store
    from accord_tpu_torch.primitives import deps, keys, timestamp as ts, txn
    return SimpleNamespace(
        Agent=spi.Agent, EventsListener=spi.EventsListener,
        ProgressLog=spi.ProgressLog, ListStore=ls.ListStore,
        ListRead=ls.ListRead, ListRangeRead=ls.ListRangeRead,
        ListQuery=ls.ListQuery, ListUpdate=ls.ListUpdate, C=cmds,
        SaveStatus=status.SaveStatus, PreLoadContext=store.PreLoadContext,
        Deps=deps.Deps, Key=keys.Key, Keys=keys.Keys, Ranges=keys.Ranges,
        Route=keys.Route, RoutingKey=keys.RoutingKey, Ballot=ts.Ballot,
        Domain=ts.Domain, Timestamp=ts.Timestamp, TxnId=ts.TxnId,
        TxnKind=ts.TxnKind, Txn=txn.Txn)


def ts_tuple(t) -> Optional[tuple]:
    return None if t is None else (t.epoch, t.hlc, t.flags, t.node)


def deps_tuple(deps) -> Optional[tuple]:
    """Deps as plain data: (sorted (token, id) key deps, sorted (start, end,
    id) range deps)."""
    if deps is None:
        return None
    kd, rd = deps.key_deps, deps.range_deps
    keyed = sorted((k.token, ts_tuple(t)) for k in kd.keys
                   for t in kd.txn_ids_for_key(k))
    ranged = sorted((rng.start, rng.end, ts_tuple(t))
                    for i, rng in enumerate(rd.ranges)
                    for t in rd.txn_ids_for_range_idx(i))
    return tuple(keyed), tuple(ranged)


class QueueScheduler:
    """A scheduler whose `now` and `once` queue their callbacks until
    `drain` runs them in order: every operation a DeviceCommandStore is
    handed between two drains falls into one flush window."""

    def __init__(self):
        self._queue = collections.deque()

    def now(self, fn) -> None:
        self._queue.append(fn)

    def once(self, delay_s: float, fn) -> None:
        self._queue.append(fn)

    def drain(self) -> None:
        while self._queue:
            self._queue.popleft()()


class StoreNode:
    """Just enough of a Node for the store tier: an HLC, an agent that
    raises on uncaught exceptions and records handled ones, a ListStore, a
    null progress log, an events listener that records each applied
    transaction as (hlc, host seconds), a data store that logs each write
    as (token, executeAt's hlc) in the order it runs, ``infer_stats`` and
    a ``QueueScheduler``."""

    def __init__(self, kit: SimpleNamespace):
        applied = self.applied = []
        writes = self.writes = []

        class _Agent(kit.Agent):
            def __init__(self):
                self.failures = []

            def on_uncaught_exception(self, failure):
                self.failures.append(failure)
                raise failure

            def on_handled_exception(self, failure):
                self.failures.append(failure)

            def empty_txn(self, kind, keys_or_ranges):
                return kit.Txn(kind, keys_or_ranges)

        class _NullProgressLog(kit.ProgressLog):
            pass

        class _Events(kit.EventsListener):
            def on_applied(self, command, apply_start_ns: int = 0) -> None:
                applied.append((command.txn_id.hlc, time.perf_counter()))

        class _LoggedListStore(kit.ListStore):
            def append(self, key, value, at) -> None:
                writes.append((key.token, at.hlc))
                super().append(key, value, at)

        self.id = 1
        self.epoch = 1
        self.kit = kit
        self.agent = _Agent()
        self.data_store = _LoggedListStore(self.id)
        self.events = _Events()
        self.scheduler = QueueScheduler()
        self.infer_stats = collections.defaultdict(int)
        self._progress_log = _NullProgressLog()
        self._hlc = 0

    def progress_log_for(self, store):
        return self._progress_log

    def now_us(self) -> int:
        return self._hlc

    def unique_now(self):
        self._hlc += 1
        return self.kit.Timestamp(self.epoch, self._hlc, 0, self.id)

    def unique_now_at_least(self, at_least):
        self._hlc = max(self._hlc, at_least.hlc) + 1
        return self.kit.Timestamp(max(self.epoch, at_least.epoch), self._hlc,
                                  0, self.id)


class _PlanTxn:
    __slots__ = ("txn_id", "txn", "route", "witnessed", "pa_deps", "acc_deps")


class LifecycleRunner:
    """Drives ops through ``store.execute(context, fn)`` with the local
    state machine's transitions (``local/commands.py``), each op as the
    protocol's message applies it: PreAccept (preaccept, then the deps up to
    the txn id), Accept (at the preaccept's executeAt, then the deps up to
    it), a stable Commit, and Apply (writes from the txn's update).  Each op
    declares the probes its message declares, so a DeviceCommandStore
    precomputes them for its window: every op its deps probe, over keys or
    ranges, and a key-domain Apply its execute probe.

    ``run_window`` submits a window's ops, drains the node's scheduler (one
    flush) and returns each op's reply as plain tuples."""

    def __init__(self, store, node: StoreNode, specs: List[tuple]):
        self.store = store
        self.node = node
        self.kit = node.kit
        self.specs = specs
        self.txns: Dict[int, _PlanTxn] = {}
        # span(name) -> a context around each op's transition
        self.span = lambda name: nullcontext()

    def run_window(self, ops) -> list:
        results = [None] * len(ops)
        for j, op in enumerate(ops):
            context, fn = getattr(self, "_" + op[0])(*op[1:])
            self.store.execute(context,
                               self._recording(fn, results, j, op[0]))
        self.node.scheduler.drain()
        return results

    def prepare(self, n: int) -> None:
        """Build the messages of the first `n` transactions ahead."""
        for i in range(n):
            self._txn(i)

    def _recording(self, fn, results, j, name):
        span = self.span

        def run(safe):
            with span("serve." + name):
                results[j] = fn(safe)
        return run

    def _txn(self, i: int) -> _PlanTxn:
        st = self.txns.get(i)
        if st is not None:
            return st
        k = self.kit
        kind, domain, hlc, node, parts, writes = self.specs[i]
        kind, domain = k.TxnKind(kind), k.Domain(domain)
        st = self.txns[i] = _PlanTxn()
        st.txn_id = k.TxnId.create(1, hlc, kind, domain, node)
        if domain == k.Domain.KEY:
            keys = k.Keys.of(*parts)
            update = (k.ListUpdate({k.Key(t): i for t in writes})
                      if kind == k.TxnKind.WRITE else None)
            txn = k.Txn(kind, keys, read=k.ListRead(keys),
                        query=k.ListQuery(), update=update)
            st.route = k.Route.of_keys(keys[0].as_routing(),
                                       keys.as_routing())
        else:
            ranges = k.Ranges.of(*parts)
            txn = k.Txn(kind, ranges, read=k.ListRangeRead(ranges),
                        query=k.ListQuery())
            st.route = k.Route.of_ranges(k.RoutingKey(parts[0][0]), ranges)
        st.txn = txn.slice(self.store.ranges, include_query=True)
        st.witnessed = st.pa_deps = st.acc_deps = None
        return st

    def _execute_at(self, st: _PlanTxn):
        return st.witnessed if st.witnessed is not None else st.txn_id

    def _deps(self, st: _PlanTxn):
        for d in (st.acc_deps, st.pa_deps):
            if d is not None:
                return d
        return self.kit.Deps.NONE

    def _preaccept(self, i: int):
        k, st = self.kit, self._txn(i)
        tid, keys = st.txn_id, st.txn.keys
        ctx = k.PreLoadContext.for_txn(
            tid, keys, deps_probes=((tid, tid.kind.witnesses(), keys),))

        def fn(safe):
            outcome, witnessed = k.C.preaccept(safe, tid, st.txn, st.route)
            deps = None
            if outcome in (k.C.AcceptOutcome.SUCCESS,
                           k.C.AcceptOutcome.REDUNDANT):
                deps = k.C.calculate_deps(safe, tid, keys, before=tid)
                if st.pa_deps is None:
                    st.witnessed, st.pa_deps = witnessed, deps
            return ("preaccept", outcome.name, ts_tuple(witnessed),
                    deps_tuple(deps))
        return ctx, fn

    def _accept(self, i: int):
        k, st = self.kit, self._txn(i)
        tid, keys, at = st.txn_id, st.txn.keys, self._execute_at(st)
        ctx = k.PreLoadContext.for_txn(
            tid, keys, deps_probes=((at, tid.kind.witnesses(), keys),))

        def fn(safe):
            outcome = k.C.accept(safe, tid, k.Ballot.ZERO, st.route, keys, at,
                                 st.pa_deps or k.Deps.NONE)
            deps = None
            if outcome in (k.C.AcceptOutcome.SUCCESS,
                           k.C.AcceptOutcome.REDUNDANT):
                deps = k.C.calculate_deps(safe, tid, keys, before=at)
                if st.acc_deps is None:
                    st.acc_deps = deps
            return ("accept", outcome.name, deps_tuple(deps))
        return ctx, fn

    def _commit(self, i: int):
        k, st = self.kit, self._txn(i)
        tid, at = st.txn_id, self._execute_at(st)
        ctx = k.PreLoadContext.for_txn(tid, st.txn.keys)

        def fn(safe):
            outcome = k.C.commit(safe, tid, st.route, st.txn, at,
                                 self._deps(st), stable=True)
            return ("commit", outcome.name)
        return ctx, fn

    def _apply(self, i: int):
        k, st = self.kit, self._txn(i)
        tid, keys, at = st.txn_id, st.txn.keys, self._execute_at(st)
        # a range transaction's Apply is planned by no wave
        probes = ((tid, at, keys),) if tid.domain == k.Domain.KEY else ()
        ctx = k.PreLoadContext.for_txn(tid, keys, execute_probes=probes)

        def fn(safe):
            writes = st.txn.execute(tid, at, None)
            outcome = k.C.apply(safe, tid, st.route, at, self._deps(st),
                                writes, None, partial_txn=st.txn)
            return ("apply", outcome.name)
        return ctx, fn
