"""Out-of-band replica corruption: the audit tentpole's nemesis arm.

Silently mutates ONE replica's decided command state — no message, no
journal record, no flight event of the mutation itself — modelling the
failures the live auditor (local/audit.py) exists to catch online: a bad
replay, a codec bug, bit rot, an operator fat-finger.  The mutation
targets a command inside the NEGOTIATED audit window (below every
replica's universal-durable floor, above every bootstrap fence) so a
subsequent digest round is guaranteed to cover it.
"""

from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local.audit import entry_class, node_floors, _audit_scope, \
    _in_ranges
from accord_tpu_torch.local.status import SaveStatus
from accord_tpu_torch.primitives.keys import Ranges
from accord_tpu_torch.primitives.timestamp import Timestamp


def corrupt_below_universal(cluster, node_id: int,
                            flip_invalidated: bool = False
                            ) -> Optional[object]:
    """Mutate one committed command on `node_id` that lies inside the
    cluster-negotiated audit window of some shard the node replicates:
    bump its executeAt hlc (default), or flip it to INVALIDATED.  Returns
    the corrupted TxnId, or None when no command is eligible yet (durable
    bounds not advanced far enough — retry after the next durability
    round)."""
    node = cluster.nodes[node_id]
    topo = node.topology.current()
    for shard in topo.shards:
        if node_id not in shard.nodes:
            continue
        ranges = Ranges([shard.range])
        # the negotiated window across the shard's LIVE replicas — what a
        # digest round would converge to
        lo = hi = None
        for rid in shard.nodes:
            if rid in cluster.dead:
                continue
            rlo, rhi = node_floors(cluster.nodes[rid], ranges)
            lo = rlo if lo is None else max(lo, rlo)
            hi = rhi if hi is None else min(hi, rhi)
        if lo is None or not (lo < hi):
            continue
        for store in node.command_stores.all():
            for txn_id, cmd in store.commands.items():
                if txn_id < lo or not (txn_id < hi):
                    continue
                ec = entry_class(cmd)
                if ec is None or ec[0] != "committed":
                    continue
                if not _in_ranges(_audit_scope(cmd), ranges):
                    continue
                if flip_invalidated:
                    # direct assignment, bypassing set_status: silent
                    # corruption must not announce itself on the flight
                    # ring — the auditor has to find it cold
                    cmd.save_status = SaveStatus.INVALIDATED
                else:
                    at = cmd.execute_at
                    cmd.execute_at = Timestamp(at.epoch, at.hlc + 1,
                                               at.flags, at.node)
                return txn_id
    return None
