"""Deterministic discrete-event simulation harness.

Reference: the burn-test cluster (accord-core test impl/basic/Cluster.java:102,
RandomDelayQueue.java:19, NodeSink.java:45, PendingQueue) — SURVEY.md §4a.
Every executor task, timer, and message delivery across a whole simulated
cluster is one Pending item in one seed-deterministic virtual-time queue.
"""

from accord_tpu_torch.sim.queue import Pending, PendingQueue, SimClock
from accord_tpu_torch.sim.scheduler import SimScheduler
