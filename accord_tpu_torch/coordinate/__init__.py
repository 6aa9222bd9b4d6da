"""Coordination state machines (reference: accord/coordinate — SURVEY.md §2.5)."""

from accord_tpu_torch.coordinate.errors import (
    CoordinationFailed, Timeout, Preempted, Invalidated, Truncated, Exhausted,
)
