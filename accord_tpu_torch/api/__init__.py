"""Integration SPI: the data plane and the host ports the store tier calls
(copies of ``accord_tpu.api.data`` and ``accord_tpu.api.spi``)."""
