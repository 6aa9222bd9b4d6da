"""Observability the store tier binds its counters through: the metrics
registry, the attribute views over it and the kernel profiler (copies of
their ``accord_tpu.obs`` counterparts)."""
