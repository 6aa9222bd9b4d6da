"""Coordination failure hierarchy (reference: accord/coordinate/
CoordinationFailed and subclasses — SURVEY.md §2.5)."""

from __future__ import annotations


class CoordinationFailed(Exception):
    pass


class Timeout(CoordinationFailed):
    pass


class Preempted(CoordinationFailed):
    """A higher ballot took over coordination/recovery."""


class Invalidated(CoordinationFailed):
    """The transaction was invalidated; it has no outcome."""


class Truncated(CoordinationFailed):
    """History needed for the outcome has been garbage collected."""


class Exhausted(CoordinationFailed):
    """Not enough live replicas to make progress."""


class StaleTopology(CoordinationFailed):
    pass


class TopologyMismatch(CoordinationFailed):
    pass


class RangeUnavailable(CoordinationFailed):
    pass
