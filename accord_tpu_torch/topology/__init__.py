"""Topology / membership layer (reference: accord/topology — SURVEY.md §2.6)."""

from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.topology.topologies import Topologies
from accord_tpu_torch.topology.manager import TopologyManager
