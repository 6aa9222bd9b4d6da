"""MultiPreAccept: one wire envelope carrying a batch's requests.

The ingest pipeline (accord_tpu_torch/pipeline/) coalesces the fan-out of a whole
micro-batch so ONE wire message per replica carries every request the
batch's coordinations sent there — dominated by PreAccepts at batch start,
plus Commits/Stables/Applies when the host loop holds a coalescing window
open across a reply burst.  The receiver unpacks each part back into the
ordinary 48-verb registry path (`Node.receive` per part, preserving each
part's own reply context, epoch gate and journaling), so the local state
machine is untouched by batching.

While the parts are applied, every local command store's flush window is
pinned (CommandStore.hold_flush/release_flush — a no-op on scalar stores):
the batched device tier therefore resolves the whole envelope's deps/
recovery/execution probes as ONE fused kernel window regardless of its
configured flush delay, which is the point of batching at admission.

The envelope itself carries MessageType None: it is transport framing, not
a protocol verb — it has no side effects of its own (each side-effecting
part journals individually), and dropping it equals dropping its parts on
a lossy link (RPC timeouts and the progress log heal, as always).
"""

from __future__ import annotations

from typing import Iterable, Tuple

from accord_tpu_torch.messages.base import Request


class MultiPreAccept(Request):
    """Batch envelope: `parts` is a tuple of (reply_context, request) pairs.

    Reply contexts are opaque transport tokens minted by the SENDER's sink
    when it registered each part's callback (an int msg-id on the framed
    hosts, an (origin, msg_id) pair in the sim); the receiver hands each
    one back through `node.reply` exactly as it would for an individually
    delivered request, so replies travel the ordinary path."""

    def __init__(self, parts: Iterable[Tuple[object, Request]]):
        self.parts = tuple(parts)

    @property
    def wait_for_epoch(self) -> int:
        # parts re-enter Node.receive individually, where each one applies
        # its own epoch gate; gating the envelope on the max would stall
        # every part behind the batch's newest-epoch member
        return 0

    def process(self, node, from_id: int, reply_context) -> None:
        stores = node.command_stores.all()
        for store in stores:
            store.hold_flush()
        try:
            for ctx, part in self.parts:
                node.receive(part, from_id, ctx)
        finally:
            for store in stores:
                store.release_flush()

    def __repr__(self):
        return f"MultiPreAccept(n={len(self.parts)})"
