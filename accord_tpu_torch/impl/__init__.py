"""Store implementations: the data store (list_store) and the device-batched
command store (device_store), copies of their ``accord_tpu.impl``
counterparts with the device calls on the port's ops."""
