"""Message plumbing: the verb registry, request/reply bases, and callbacks.

Reference: accord/messages/MessageType.java:34-82 (48 verbs: 44 remote + 4
local-only PROPAGATE), TxnRequest.java:42 (scope computation :259-270,
waitForEpoch :235-252; `process()` IS the map-reduce over command stores),
Callback.java / SafeCallback.java (executor-affine reply callbacks).
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Optional, TYPE_CHECKING

from accord_tpu_torch.primitives.keys import Ranges, Route
from accord_tpu_torch.primitives.timestamp import TxnId
from accord_tpu_torch.utils import invariants

if TYPE_CHECKING:
    from accord_tpu_torch.local.node import Node


class MessageType(enum.Enum):
    """The complete verb set (MessageType.java:34-82). `has_side_effects`
    drives journaling: verbs that mutate durable command state must be
    replayable."""

    PRE_ACCEPT_REQ = ("PRE_ACCEPT_REQ", True)
    PRE_ACCEPT_RSP = ("PRE_ACCEPT_RSP", False)
    ACCEPT_REQ = ("ACCEPT_REQ", True)
    ACCEPT_RSP = ("ACCEPT_RSP", False)
    ACCEPT_INVALIDATE_REQ = ("ACCEPT_INVALIDATE_REQ", True)
    GET_DEPS_REQ = ("GET_DEPS_REQ", False)
    GET_DEPS_RSP = ("GET_DEPS_RSP", False)
    GET_EPHEMERAL_READ_DEPS_REQ = ("GET_EPHEMERAL_READ_DEPS_REQ", False)
    GET_EPHEMERAL_READ_DEPS_RSP = ("GET_EPHEMERAL_READ_DEPS_RSP", False)
    GET_MAX_CONFLICT_REQ = ("GET_MAX_CONFLICT_REQ", False)
    GET_MAX_CONFLICT_RSP = ("GET_MAX_CONFLICT_RSP", False)
    COMMIT_SLOW_PATH_REQ = ("COMMIT_SLOW_PATH_REQ", True)
    COMMIT_MAXIMAL_REQ = ("COMMIT_MAXIMAL_REQ", True)
    STABLE_FAST_PATH_REQ = ("STABLE_FAST_PATH_REQ", True)
    STABLE_SLOW_PATH_REQ = ("STABLE_SLOW_PATH_REQ", True)
    STABLE_MAXIMAL_REQ = ("STABLE_MAXIMAL_REQ", True)
    COMMIT_INVALIDATE_REQ = ("COMMIT_INVALIDATE_REQ", True)
    APPLY_MINIMAL_REQ = ("APPLY_MINIMAL_REQ", True)
    APPLY_MAXIMAL_REQ = ("APPLY_MAXIMAL_REQ", True)
    APPLY_RSP = ("APPLY_RSP", False)
    READ_REQ = ("READ_REQ", False)
    READ_EPHEMERAL_REQ = ("READ_EPHEMERAL_REQ", False)
    READ_RSP = ("READ_RSP", False)
    BEGIN_RECOVER_REQ = ("BEGIN_RECOVER_REQ", True)
    BEGIN_RECOVER_RSP = ("BEGIN_RECOVER_RSP", False)
    BEGIN_INVALIDATE_REQ = ("BEGIN_INVALIDATE_REQ", True)
    BEGIN_INVALIDATE_RSP = ("BEGIN_INVALIDATE_RSP", False)
    WAIT_ON_COMMIT_REQ = ("WAIT_ON_COMMIT_REQ", False)
    WAIT_ON_COMMIT_RSP = ("WAIT_ON_COMMIT_RSP", False)
    WAIT_UNTIL_APPLIED_REQ = ("WAIT_UNTIL_APPLIED_REQ", False)
    INFORM_OF_TXN_REQ = ("INFORM_OF_TXN_REQ", True)
    INFORM_DURABLE_REQ = ("INFORM_DURABLE_REQ", True)
    INFORM_HOME_DURABLE_REQ = ("INFORM_HOME_DURABLE_REQ", True)
    CHECK_STATUS_REQ = ("CHECK_STATUS_REQ", False)
    CHECK_STATUS_RSP = ("CHECK_STATUS_RSP", False)
    FETCH_DATA_REQ = ("FETCH_DATA_REQ", False)
    FETCH_DATA_RSP = ("FETCH_DATA_RSP", False)
    SET_SHARD_DURABLE_REQ = ("SET_SHARD_DURABLE_REQ", True)
    SET_GLOBALLY_DURABLE_REQ = ("SET_GLOBALLY_DURABLE_REQ", True)
    QUERY_DURABLE_BEFORE_REQ = ("QUERY_DURABLE_BEFORE_REQ", False)
    QUERY_DURABLE_BEFORE_RSP = ("QUERY_DURABLE_BEFORE_RSP", False)
    APPLY_THEN_WAIT_UNTIL_APPLIED_REQ = ("APPLY_THEN_WAIT_UNTIL_APPLIED_REQ", True)
    # replica-state auditor (messages/audit.py): read-only cross-replica
    # range digests + drill-down entry fetches — never journaled
    AUDIT_DIGEST_REQ = ("AUDIT_DIGEST_REQ", False)
    AUDIT_DIGEST_RSP = ("AUDIT_DIGEST_RSP", False)
    AUDIT_ENTRIES_REQ = ("AUDIT_ENTRIES_REQ", False)
    AUDIT_ENTRIES_RSP = ("AUDIT_ENTRIES_RSP", False)
    # live-elasticity admin plane (messages/admin.py): epoch installs gossip
    # node-to-node and must be journaled before the admin ack; drain and
    # bootstrap-progress records are WAL lifecycle markers that crash-restart
    # replays to resume (not restart) an interrupted reshard
    EPOCH_INSTALL_MSG = ("EPOCH_INSTALL_MSG", True)
    TOPOLOGY_FETCH_REQ = ("TOPOLOGY_FETCH_REQ", False)
    TOPOLOGY_FETCH_RSP = ("TOPOLOGY_FETCH_RSP", False)
    DRAIN_BEGIN_MSG = ("DRAIN_BEGIN_MSG", True)
    DRAIN_DONE_MSG = ("DRAIN_DONE_MSG", True)
    BOOTSTRAP_CHECKPOINT_MSG = ("BOOTSTRAP_CHECKPOINT_MSG", True)
    BOOTSTRAP_DONE_MSG = ("BOOTSTRAP_DONE_MSG", True)
    # bounded-memory paging tier (messages/paging.py): spill frames and
    # fault-index checkpoints live in the pager's per-incarnation spill
    # store, NEVER the node WAL — has_side_effects=False keeps the live
    # journal path from ever framing one
    SPILL_FRAME_MSG = ("SPILL_FRAME_MSG", False)
    FAULT_INDEX_CHECKPOINT_MSG = ("FAULT_INDEX_CHECKPOINT_MSG", False)
    SIMPLE_RSP = ("SIMPLE_RSP", False)
    FAILURE_RSP = ("FAILURE_RSP", False)
    # local-only (never cross the network; applied via Node.local_request)
    PROPAGATE_PRE_ACCEPT_MSG = ("PROPAGATE_PRE_ACCEPT_MSG", True)
    PROPAGATE_STABLE_MSG = ("PROPAGATE_STABLE_MSG", True)
    PROPAGATE_APPLY_MSG = ("PROPAGATE_APPLY_MSG", True)
    PROPAGATE_OTHER_MSG = ("PROPAGATE_OTHER_MSG", True)

    def __init__(self, label: str, has_side_effects: bool):
        self.label = label
        self.has_side_effects = has_side_effects


class Message:
    type: MessageType = None  # set by subclasses
    # optional per-transaction trace id (obs/spans.py), stamped by
    # Node.send on requests that carry a txn_id.  Set as an INSTANCE
    # attribute so host/wire.py's structural codec round-trips it inside
    # the existing wire envelope; the class default keeps untraced
    # messages allocation-free.
    trace_id: Optional[str] = None


class Reply(Message):
    pass


class Request(Message):
    """A message processed by the receiving node."""

    def process(self, node: "Node", from_id: int, reply_context) -> None:
        raise NotImplementedError

    @property
    def wait_for_epoch(self) -> int:
        """Epoch the receiver must know before processing (TxnRequest
        .waitForEpoch); 0 = no gate."""
        return 0


class TxnRequest(Request):
    """Routed request: carries the per-destination scope slice of the route.
    The request object itself is the map-reduce over intersecting command
    stores (TxnRequest implements MapReduceConsume)."""

    def __init__(self, txn_id: TxnId, scope: Route, wait_for_epoch: int = 0,
                 min_epoch: int = 0, full_route: Optional[Route] = None):
        self.txn_id = txn_id
        self.scope = scope
        # the un-sliced route travels alongside the per-destination scope so
        # every witness can recover the txn (reference PreAccept.java:51,
        # Commit.java:78 carry FullRoute)
        self.full_route = full_route
        self._wait_for_epoch = wait_for_epoch
        self.min_epoch = min_epoch or (wait_for_epoch or txn_id.epoch)

    @property
    def route(self) -> Route:
        """Best route knowledge to record on the command."""
        return self.full_route if self.full_route is not None else self.scope

    @property
    def wait_for_epoch(self) -> int:
        return self._wait_for_epoch or self.txn_id.epoch

    # (id(route), id(owned)) -> (route, owned, scope): a coordination's 3-4
    # rounds re-slice the SAME route object by the SAME memoized per-node
    # Ranges per destination.  Values hold strong refs to both key objects
    # (a live entry's ids cannot be recycled); bounded by wholesale clear.
    _SCOPE_MEMO: Dict[tuple, tuple] = {}

    @staticmethod
    def compute_scope(to_node: int, topologies, route: Route) -> Optional[Route]:
        """Slice of `route` owned by `to_node` across the epoch window
        (TxnRequest.computeScope :259-270)."""
        owned = None
        for topology in topologies:
            r = topology.ranges_for_node(to_node)
            # single-epoch window (the common case): reuse the topology's
            # memoized Ranges without a union copy + renormalize
            owned = r if owned is None else owned.union(r)
        if owned is None:
            owned = Ranges.EMPTY
        memo = TxnRequest._SCOPE_MEMO
        key = (id(route), id(owned))
        hit = memo.get(key)
        if hit is not None and hit[0] is route and hit[1] is owned:
            return hit[2]
        scope = route.slice(owned) if route.intersects(owned) else None
        if len(memo) > 1024:
            memo.clear()
        memo[key] = (route, owned, scope)
        return scope

    def process(self, node: "Node", from_id: int, reply_context) -> None:
        node.map_reduce_consume_local(self, from_id, reply_context)

    # subclasses implement the map/reduce:
    def apply(self, safe_store):
        raise NotImplementedError

    def reduce(self, a, b):
        raise NotImplementedError

    def participants(self):
        return self.scope.participants()

    def deps_probe(self):
        """(before, witness KindSet, data Keys) of the active-conflict scan
        apply() will run, or None. Lets a batched device store precompute the
        window's deps in one kernel call (PreLoadContext.deps_probes)."""
        return None

    def recovery_probe(self):
        """(txn_id, data Keys) of the recovery predicate scans apply() will
        run (the four mapReduceFull queries of BeginRecovery), or None —
        the batched device store precomputes them per flush window
        (PreLoadContext.recovery_probes, ops/recovery_kernel.py)."""
        return None

    def execute_probe(self):
        """(txn_id, execute_at, data Keys) of the execution this message
        delivers (Apply), or None — the batched device store plans the
        flush window's apply order with the wavefront kernel
        (PreLoadContext.execute_probes, ops/wavefront.py)."""
        return None


class SimpleReply(Reply):
    type = MessageType.SIMPLE_RSP

    OK = "Ok"
    NACK = "Nack"

    def __init__(self, outcome: str):
        self.outcome = outcome

    def __eq__(self, other):
        return isinstance(other, SimpleReply) and self.outcome == other.outcome

    def __repr__(self):
        return f"SimpleReply({self.outcome})"


class FailureReply(Reply):
    type = MessageType.FAILURE_RSP

    def __init__(self, failure: BaseException):
        self.failure = failure

    def __repr__(self):
        return f"FailureReply({self.failure!r})"


class Callback:
    """Reply callback for a request sent with Node.send (Callback.java).
    Delivery is pinned to the sending executor in the reference; our stores are
    logically single-threaded so delivery order is the simulator's concern."""

    def on_success(self, from_id: int, reply: Reply) -> None:
        raise NotImplementedError

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        raise NotImplementedError

    def on_callback_failure(self, from_id: int, failure: BaseException) -> None:
        raise failure


class RoundCallback(Callback):
    """Tags replies/failures with the round they belong to, so multi-round
    coordinators (deps->read, stable->apply) can discard stragglers from a
    superseded round instead of mis-crediting them to the current tracker
    (the reference pins callbacks per-message for the same reason,
    SafeCallback.java)."""

    def __init__(self, owner, round_id):
        self.owner = owner
        self.round_id = round_id

    def on_success(self, from_id: int, reply: Reply) -> None:
        self.owner.on_round_success(self.round_id, from_id, reply)

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        self.owner.on_round_failure(self.round_id, from_id, failure)


class FunctionCallback(Callback):
    def __init__(self, on_success: Callable[[int, Reply], None],
                 on_failure: Callable[[int, BaseException], None] = None):
        self._on_success = on_success
        self._on_failure = on_failure

    def on_success(self, from_id: int, reply: Reply) -> None:
        self._on_success(from_id, reply)

    def on_failure(self, from_id: int, failure: BaseException) -> None:
        if self._on_failure is not None:
            self._on_failure(from_id, failure)
