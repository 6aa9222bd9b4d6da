"""ReadCoordinator: the generic quorum-read retry machine.

Reference: accord/coordinate/ReadCoordinator.java — Action.Approve /
Action.TryAlternative: one data response per shard suffices; a failed or
slow replica is replaced by an untried alternative from the same shard until
every shard has answered or a shard runs out of candidates. Shared by the
execution read (ExecutePath: reads piggyback on the Stable round, retries go
out as plain ReadTxnData) and the ephemeral read round.
"""

from __future__ import annotations

from typing import Callable, List

from accord_tpu_torch.coordinate.tracking import ReadTracker, RequestStatus


class ReadCoordinator:
    """Owns the ReadTracker; the caller sends (initial reads may piggyback
    on another round, so `initial_contacts` only *picks*) and feeds replies
    back through on_data / on_slow_or_failed."""

    def __init__(self, node, topologies, send_read: Callable[[int], None],
                 on_exhausted: Callable[[], None]):
        self.node = node
        self.topologies = topologies
        self.tracker = ReadTracker(topologies)
        self._send_read = send_read
        self._on_exhausted = on_exhausted
        self.exhausted = False

    @property
    def contacted(self):
        """Every node a read was (or is being) attempted against — the
        tracker maintains this as contacts and alternatives are chosen."""
        return self.tracker.contacted

    def initial_contacts(self) -> List[int]:
        """One replica per shard, topology-sorter order, self first."""
        prefer = [self.node.id] + self.node.topology.sorter.sort(
            self.topologies.nodes(), self.topologies)
        return self.tracker.initial_contacts(prefer)

    @property
    def has_all_data(self) -> bool:
        return all(t.has_data for t in self.tracker.trackers)

    def on_data(self, from_id: int) -> bool:
        """Approve: record a data response; True once every shard has one."""
        return (self.tracker.record_read_success(from_id)
                == RequestStatus.SUCCESS)

    def on_slow_or_failed(self, from_id: int) -> None:
        """TryAlternative: replace this replica with an untried one from each
        shard it was covering; exhaust when some shard has no candidates."""
        if self.exhausted:
            return
        status, retry = self.tracker.record_read_failure(from_id)
        if status == RequestStatus.FAILED:
            self.exhausted = True
            self._on_exhausted()
            return
        for to in retry:
            self._send_read(to)
