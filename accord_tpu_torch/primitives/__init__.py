"""Protocol data model (copies of accord_tpu.primitives: timestamps, keys
and ranges, deps, txns and writes)."""
