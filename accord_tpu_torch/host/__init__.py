"""External host tier: wire codec, real-time runtime, Maelstrom protocol.

Reference: accord-maelstrom (Main.java:145 stdin JSON-RPC node, Json.java
wire codec, Cluster.java in-process runner) — the black-box face of the
framework: real processes, a real serialization boundary, driven by an
external workload and checked by the same strict-serializability verifier
the burn test uses.
"""

from accord_tpu_torch.host.wire import decode_message, encode_message
