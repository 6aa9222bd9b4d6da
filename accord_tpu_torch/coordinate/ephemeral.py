"""CoordinateEphemeralRead: deps quorum + tracked read, one round each.

Reference: the ephemeral-read coordination over GET_EPHEMERAL_READ_DEPS_REQ /
READ_EPHEMERAL_REQ (accord/coordinate — the CoordinationAdapter ephemeral
path; GetEphemeralReadDeps.java, which loops the deps round until the
replica-reported latest epoch stops advancing). The read is never witnessed:
no recovery, no progress-log entry; a failed round simply retries another
replica or reports Timeout/Exhausted to the client.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from accord_tpu_torch.coordinate.errors import Exhausted, Timeout
from accord_tpu_torch.coordinate.tracking import (QuorumTracker,
                                            RequestStatus)
from accord_tpu_torch.messages.base import Callback, RoundCallback, TxnRequest
from accord_tpu_torch.messages.ephemeral import (GetEphemeralReadDeps,
                                           GetEphemeralReadDepsOk,
                                           ReadEphemeralTxnData)
from accord_tpu_torch.messages.read import ReadNack, ReadOk
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keys import Route
from accord_tpu_torch.primitives.timestamp import TxnId
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.topology.topologies import Topologies
from accord_tpu_torch.utils.async_chains import AsyncResult


class CoordinateEphemeralRead:
    def __init__(self, node, txn_id: TxnId, txn: Txn, result: AsyncResult):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = node.compute_route(txn)
        self.result = result
        self.epoch = txn_id.epoch
        self.deps_tracker: Optional[QuorumTracker] = None
        self.reads = None  # ReadCoordinator for the read round
        self.read_topologies: Optional[Topologies] = None
        self.deps_oks: Dict[int, GetEphemeralReadDepsOk] = {}
        self.generation = 0  # bumped per round; stragglers are discarded
        self.deps: Deps = Deps.NONE
        self.data = None
        self.reading = False
        self.done = False

    # ------------------------------------------------------- deps round --
    def start(self) -> None:
        self.deps_oks.clear()
        self.generation += 1
        # per-phase SLO attribution (obs/spans.PHASE_ORDER): the ephemeral
        # path's two rounds are milestones like preaccept/commit are for
        # witnessed txns; an epoch-advance redo re-stamps (first one wins)
        self.node.obs.txn_phase(self.txn_id, "eph_deps",
                                epoch=self.epoch)
        cb = RoundCallback(self, ("deps", self.generation))
        topologies = self.node.topology.with_unsynced_epochs(
            self.route.participants(), self.txn_id.epoch, self.epoch)
        self.deps_tracker = QuorumTracker(topologies)
        for to in topologies.nodes():
            scope = TxnRequest.compute_scope(to, topologies, self.route)
            if scope is None:
                continue
            keys = self.txn.keys.slice(scope.covering())
            self.node.send(to, GetEphemeralReadDeps(self.txn_id, scope, keys),
                           callback=cb)

    def _on_deps_quorum(self) -> None:
        self.deps = Deps.merge([ok.deps for ok in self.deps_oks.values()])
        latest = max(ok.latest_epoch for ok in self.deps_oks.values())
        if latest > self.epoch:
            # replicas have advanced: redo the deps round so the quorum also
            # intersects the newer topology (the reference loops until the
            # reported epoch stabilises). Invalidate the current round NOW —
            # the restart may be deferred on with_epoch, and a straggler from
            # this round re-reaching quorum would otherwise start a read
            # round the restart then orphans
            self.epoch = latest
            self.generation += 1
            self.node.with_epoch(latest, self.start)
            return
        self._start_read()

    def _is_current(self, round_id) -> bool:
        phase, gen = round_id
        if gen != self.generation:
            return False
        return phase == ("read" if self.reading else "deps")

    def on_round_success(self, round_id, from_id: int, reply) -> None:
        if self.done or not self._is_current(round_id):
            return  # straggler from a superseded round
        if not self.reading:
            assert isinstance(reply, GetEphemeralReadDepsOk)
            self.deps_oks[from_id] = reply
            if self.deps_tracker.record_success(from_id) == RequestStatus.SUCCESS:
                self._on_deps_quorum()
            return
        if isinstance(reply, ReadNack):
            self._retry_read(from_id)
            return
        if isinstance(reply, ReadOk):
            if reply.data is not None:
                self.data = (reply.data if self.data is None
                             else self.data.merge(reply.data))
            if self.reads.on_data(from_id):
                self.done = True
                self.result.try_success(
                    self.txn.result(self.txn_id, self.txn_id, self.data))

    def on_round_failure(self, round_id, from_id: int,
                         failure: BaseException) -> None:
        if self.done or not self._is_current(round_id):
            return
        if self.reading:
            self._retry_read(from_id)
            return
        if self.deps_tracker.record_failure(from_id) == RequestStatus.FAILED:
            self.done = True
            self.result.try_failure(
                failure if isinstance(failure, Timeout)
                else Exhausted(repr(failure)))

    # ------------------------------------------------------- read round --
    def _start_read(self) -> None:
        from accord_tpu_torch.coordinate.read_coord import ReadCoordinator
        self.node.obs.txn_phase(self.txn_id, "eph_read")
        self.reading = True
        self.generation += 1
        selected = self.node.topology.current().for_selection(
            self.route.participants())
        self.read_topologies = Topologies([selected])

        def exhausted():
            self.done = True
            self.result.try_failure(Exhausted("ephemeral read exhausted"))

        self.reads = ReadCoordinator(self.node, self.read_topologies,
                                     self._send_read, exhausted)
        for to in self.reads.initial_contacts():
            self._send_read(to)

    def _send_read(self, to: int) -> None:
        scope = TxnRequest.compute_scope(to, self.read_topologies, self.route)
        if scope is None:
            # tracker and scope derive from the same snapshot, so this should
            # be unreachable; treat defensively as a failed read rather than
            # leaving the tracker waiting forever
            self._retry_read(to)
            return
        owned = scope.covering()
        self.node.send(
            to, ReadEphemeralTxnData(
                self.txn_id, scope, self.txn.keys.slice(owned),
                self.txn.slice(owned, include_query=True),
                self.deps.slice(owned), self.epoch),
            callback=RoundCallback(self, ("read", self.generation)))

    def _retry_read(self, from_id: int) -> None:
        self.reads.on_slow_or_failed(from_id)
