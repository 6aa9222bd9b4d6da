"""Local replica state machine (reference: accord/local — SURVEY.md §2.3)."""

from accord_tpu_torch.local.status import (
    SaveStatus, Phase, Durability, Known, KnownRoute, KnownDefinition,
    KnownExecuteAt, KnownDeps, KnownOutcome,
)
from accord_tpu_torch.local.command import Command, WaitingOn
