"""Utilities the port needs: invariants, deterministic randomness, sorted
arrays, bitsets, interval maps, async chains, device selection (copies of
their accord_tpu.utils counterparts where one exists)."""
