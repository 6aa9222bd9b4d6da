"""Local replica state: the per-key conflict index (cfk), commands and their
statuses, the command store and the local state machine's transitions
(commands), copies of their ``accord_tpu.local`` counterparts."""
