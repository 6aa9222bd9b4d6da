"""AbstractConfigurationService: the epoch-history topology feed.

Reference: accord/impl/AbstractConfigurationService.java — an ordered
per-epoch ledger (received -> acknowledged async stages), listener fan-out,
and gap-driven fetches: reporting epoch N when N-1 is unknown asks the
transport to fetch the missing predecessors, so listeners always observe
epochs in order. Transport-specific subclasses implement `fetch_topology`;
the sim's subclass resolves against the cluster's ledger directly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from accord_tpu_torch.api.spi import ConfigurationService, EpochReady
from accord_tpu_torch.utils import invariants
from accord_tpu_torch.utils.async_chains import AsyncResult


class EpochState:
    __slots__ = ("epoch", "received", "acknowledged", "topology")

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.received: AsyncResult = AsyncResult()      # -> Topology
        self.acknowledged: AsyncResult = AsyncResult()  # -> None
        self.topology = None

    def __repr__(self):
        return f"EpochState({self.epoch})"


class EpochHistory:
    """Contiguous epoch ledger (AbstractEpochHistory)."""

    def __init__(self):
        self._epochs: List[EpochState] = []
        self.last_received = 0
        self.last_acknowledged = 0

    @property
    def min_epoch(self) -> int:
        return self._epochs[0].epoch if self._epochs else 0

    @property
    def max_epoch(self) -> int:
        return self._epochs[-1].epoch if self._epochs else 0

    def get_or_create(self, epoch: int) -> EpochState:
        invariants.check_argument(epoch > 0, "epochs start at 1")
        if not self._epochs:
            self._epochs.append(EpochState(epoch))
            return self._epochs[0]
        # extend below / above so the ledger stays contiguous
        while epoch < self._epochs[0].epoch:
            self._epochs.insert(0, EpochState(self._epochs[0].epoch - 1))
        while epoch > self._epochs[-1].epoch:
            self._epochs.append(EpochState(self._epochs[-1].epoch + 1))
        return self._epochs[epoch - self._epochs[0].epoch]

    def get(self, epoch: int) -> Optional[EpochState]:
        if not self._epochs \
                or not self._epochs[0].epoch <= epoch <= self._epochs[-1].epoch:
            return None
        return self._epochs[epoch - self._epochs[0].epoch]

    def truncate_until(self, epoch: int) -> None:
        """Shed epochs below `epoch` (topology GC)."""
        while self._epochs and self._epochs[0].epoch < epoch:
            self._epochs.pop(0)


class AbstractConfigurationService(ConfigurationService):
    # epoch-install gossip pacing: resend the install to topology members
    # that have not reported sync-complete, once per interval, for a
    # bounded number of rounds (partition-heal convergence without an
    # unbounded background chatter)
    GOSSIP_INTERVAL_S = 1.0
    GOSSIP_ROUNDS = 30

    def __init__(self, local_id: int):
        self.local_id = local_id
        self.epochs = EpochHistory()
        self.listeners: List = []
        self._fetching: Dict[int, bool] = {}
        self._delivered = 0  # highest epoch fanned out to listeners
        self.node = None          # set by attach_node
        self._specs: Dict[int, object] = {}  # epoch -> EpochInstall spec

    # ---------------------------------------------------------------- query --
    def current_topology(self):
        e = self.epochs.get(self.epochs.last_received)
        return e.topology if e is not None else None

    def get_topology_for_epoch(self, epoch: int):
        e = self.epochs.get(epoch)
        return e.topology if e is not None else None

    def register_listener(self, listener) -> None:
        self.listeners.append(listener)

    def attach_node(self, node) -> None:
        """Register a Node as listener AND wire its lazy epoch acquisition:
        Node.with_epoch on an epoch nobody has gossiped yet must actively
        fetch it (reference Node.withEpoch ->
        ConfigurationService.fetchTopologyForEpoch) — without the hook, an
        epoch-extension round or a message gated on a future epoch waits
        forever on gossip that may be lost."""
        self.register_listener(node)
        node.topology.set_fetch_hook(self.fetch_topology_for_epoch)
        self.node = node
        node.config_service = self

    # ---------------------------------------------------------- admin plane --
    def spec_for(self, epoch: int):
        """The EpochInstall spec this service witnessed for `epoch` (serves
        TopologyFetchReq gap fetches), or None."""
        return self._specs.get(epoch)

    def remember_spec(self, install) -> None:
        """Record an install spec without (re)applying it — used for the
        startup epoch, which is built locally rather than received."""
        self._specs.setdefault(install.epoch, install)

    def on_epoch_install(self, install, from_id: int) -> bool:
        """One EpochInstall witnessed (admin frame, gossip, or journal
        replay): dedupe against the ledger, apply through report_topology's
        in-order delivery, and gossip onward so a single admin contact
        converges the whole membership.  Returns False on a duplicate."""
        epoch = install.epoch
        if epoch in self._specs:
            return False
        self._specs[epoch] = install
        if install.peers:
            self.install_peers(install.peers)
        # decoded installs are __new__ + setattr (host/wire.py), so frames
        # from pre-geo senders simply lack the attribute
        if getattr(install, "geo", None):
            self.install_geo(install.geo)
        node = self.node
        if node is not None:
            node.obs.flight.record("epoch_install", None, (epoch, from_id))
        self.report_topology(install.build_topology())
        if node is not None and not getattr(node, "replaying", False):
            self._gossip_install(install, self.GOSSIP_ROUNDS)
        return True

    def install_peers(self, peers) -> None:
        """Transport hook: learn addresses for nodes joining in an installed
        epoch (the TCP host merges them into its peer table)."""

    def install_geo(self, geo) -> None:
        """Transport hook: a geo placement profile arrived with an epoch
        install (`GeoProfile.to_wire()` form); the TCP host rebuilds its
        egress delay shim from it."""

    def _gossip_install(self, install, rounds: int) -> None:
        node = self.node
        topology = self.get_topology_for_epoch(install.epoch)
        if node is None or topology is None:
            return
        behind = [to for to in sorted(topology.nodes())
                  if to != node.id
                  and not node.topology.epoch_acked_by(install.epoch, to)]
        for to in behind:
            node.send(to, install)
        if not behind or rounds <= 0:
            return
        node.scheduler.once(
            self.GOSSIP_INTERVAL_S,
            lambda: self._gossip_install(install, rounds - 1))

    # ----------------------------------------------------------------- feed --
    def report_topology(self, topology, start_sync: bool = True) -> None:
        """Record an epoch's topology; listeners observe epochs STRICTLY in
        order — an epoch arriving above a gap is buffered in the ledger, the
        missing predecessors are fetched, and delivery resumes once the
        prefix is contiguous (AbstractConfigurationService.reportTopology)."""
        epoch = topology.epoch
        self._fetching.pop(epoch, None)
        state = self.epochs.get_or_create(epoch)
        if state.topology is not None:
            return  # duplicate report
        state.topology = topology
        self.epochs.last_received = max(self.epochs.last_received, epoch)
        state.received.try_success(topology)
        self._deliver_contiguous(start_sync)

    def _deliver_contiguous(self, start_sync: bool) -> None:
        while True:
            nxt = (self._delivered + 1 if self._delivered
                   else self.epochs.min_epoch)
            state = self.epochs.get(nxt)
            if state is None:
                return
            if state.topology is None:
                # a gap: acquire it, delivery resumes when it reports
                self.fetch_topology_for_epoch(nxt)
                return
            self._delivered = nxt
            for listener in self.listeners:
                listener.on_topology_update(state.topology,
                                            start_sync=start_sync)

    def acknowledge_epoch(self, ready: EpochReady,
                          start_sync: bool = True) -> None:
        state = self.epochs.get_or_create(ready.epoch)
        self.epochs.last_acknowledged = max(self.epochs.last_acknowledged,
                                            ready.epoch)
        state.acknowledged.try_success(None)

    def fetch_topology_for_epoch(self, epoch: int) -> None:
        if self.get_topology_for_epoch(epoch) is not None \
                or self._fetching.get(epoch):
            return
        self._fetching[epoch] = True
        self.fetch_topology(epoch)

    # ------------------------------------------------------------ transport --
    def fetch_topology(self, epoch: int) -> None:
        """Transport hook: acquire `epoch` and call report_topology."""
        raise NotImplementedError


class DirectConfigService(AbstractConfigurationService):
    """Sim/host service: fetches resolve against a shared topology ledger
    (the cluster's, or the deterministically derived static topology)."""

    def __init__(self, local_id: int, lookup=None):
        super().__init__(local_id)
        self._lookup = lookup  # epoch -> Topology | None

    def fetch_topology(self, epoch: int) -> None:
        if self._lookup is None:
            self._fetching.pop(epoch, None)
            return
        topology = self._lookup(epoch)
        if topology is None:
            # not available yet: clear the in-flight flag so a later
            # attempt can retry (a stuck flag would suppress the fetch
            # forever and leave the gap unhealed)
            self._fetching.pop(epoch, None)
            return
        self.report_topology(topology)


class LedgerConfigService(AbstractConfigurationService):
    """Live-host service: no shared ledger exists, so epoch gaps are fetched
    from peers over the transport (TopologyFetchReq against any member of
    the newest topology we know)."""

    FETCH_TIMEOUT_S = 2.0

    def __init__(self, local_id: int, peers_hook=None, geo_hook=None):
        super().__init__(local_id)
        self._peers_hook = peers_hook
        self._geo_hook = geo_hook
        self._fetch_rr = 0  # round-robin cursor over candidate sources

    def install_peers(self, peers) -> None:
        if self._peers_hook is not None:
            self._peers_hook(peers)

    def install_geo(self, geo) -> None:
        if self._geo_hook is not None:
            self._geo_hook(geo)

    def fetch_topology(self, epoch: int) -> None:
        spec = self._specs.get(epoch)
        if spec is not None:
            self._fetching.pop(epoch, None)
            self.report_topology(spec.build_topology())
            return
        node = self.node
        current = self.current_topology()
        if node is None or current is None:
            self._fetching.pop(epoch, None)
            return
        candidates = [n for n in sorted(current.nodes()) if n != node.id]
        if not candidates:
            self._fetching.pop(epoch, None)
            return
        from accord_tpu_torch.messages.admin import TopologyFetchOk, TopologyFetchReq
        from accord_tpu_torch.messages.base import FunctionCallback
        to = candidates[self._fetch_rr % len(candidates)]
        self._fetch_rr += 1

        def on_ok(from_id, reply):
            self._fetching.pop(epoch, None)
            if isinstance(reply, TopologyFetchOk):
                # deliver through node.receive so the install is JOURNALED:
                # an epoch learned only via fetch must still survive a crash
                node.receive(reply.install, from_id, None)

        def on_fail(from_id, failure):
            # clear the in-flight flag; the 1 Hz epoch-fetch chain retries
            self._fetching.pop(epoch, None)

        node.send(to, TopologyFetchReq(epoch),
                  callback=FunctionCallback(on_ok, on_fail),
                  timeout_s=self.FETCH_TIMEOUT_S)
