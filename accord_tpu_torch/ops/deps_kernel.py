"""Batched dependency calculation — the plain PyTorch versions.

The counterpart of ``accord_tpu/ops/deps_kernel.py``: for a whole window of B
new transactions at once, the dependency set the reference derives one txn
and one key at a time in CommandsForKey.mapReduceActive (reference
accord/local/CommandsForKey.java:614-650).

Formulation over the rank encoding (ops/encode.py):
    base[b, e] = touches[b, key(e)]           # txn b reads/writes entry e's key
               & rank(e) < rank(b)            # entry started before txn b
               & witnesses(kind(b), kind(e))  # txn-kind conflict matrix
               & status(e) in 1..6            # not TRANSITIVELY_KNOWN/INVALID
    elided[b, e] = committed(e) & eat(e) < succ_w(e) < rank(b)
where succ_w[e] is the smallest committed-write executeAt rank strictly above
eat(e) at the same key, a per-entry value independent of the querying txn.

These functions are the CPU path and the oracle the CUDA deps tile
(csrc/deps_tile.cu, via ops/cuda_kernels.py) is held ``==`` to.  All outputs
are integer or boolean, so the tolerance everywhere is exact equality.
"""

from __future__ import annotations

import torch

from accord_tpu_torch.ops.encode import STATUS_INACTIVE, WRITE_KIND_MASK

# InternalStatus numeric bands (accord_tpu_torch.local.cfk.InternalStatus)
_TRANSITIVELY_KNOWN = 0
_COMMITTED = 4
_APPLIED = 6

_BIG = torch.iinfo(torch.int32).max


def _successor_write_eat(entry_key: torch.Tensor, entry_eat_rank: torch.Tensor,
                         write_eat: torch.Tensor) -> torch.Tensor:
    """succ_w[e] = smallest committed-write eat_rank strictly above
    entry e's eat_rank at the same key (_BIG when none).  `write_eat` is
    each entry's own eat_rank where it is a committed write, else _BIG.

    Entries sorted by (key, eat) put each key's history contiguous and
    ascending, so the successor is a segmented exclusive suffix-min of the
    write eats: the JAX package runs a segmented associative scan.  Since
    the write eats ascend along the sorted order too, that min is the eat of
    the FIRST write after the entry, when it has the entry's key.  With
    nxt[p] = the number of writes at sorted positions <= p (a cumsum), the
    writes after p start at index nxt[p] of the list of writes, which one
    scatter builds without a host sync."""
    e = entry_key.shape[0]
    # one stable sort by (key, eat): the order of the JAX two-pass lexsort
    composite = (entry_key.to(torch.int64) << 32) \
        + (entry_eat_rank.to(torch.int64) + 2 ** 31)
    order = torch.argsort(composite, stable=True)
    ks = entry_key[order]
    ws = write_eat[order]
    is_w = ws != _BIG
    nxt = torch.cumsum(is_w, 0)
    # write j lands at slot j; every other entry on the spare slot e, which
    # is never read (nxt[p] < number of writes <= e where it is)
    slot = torch.where(is_w, nxt - 1, e)
    w_key = torch.zeros(e + 1, dtype=ks.dtype, device=ks.device)
    w_eat = torch.full((e + 1,), _BIG, dtype=ws.dtype, device=ws.device)
    w_key[slot] = ks
    w_eat[slot] = ws
    has_next = (nxt < nxt[-1:]) & (w_key[nxt] == ks)
    succ = torch.empty_like(entry_eat_rank)
    succ[order] = torch.where(has_next, w_eat[nxt], _BIG).to(succ.dtype)
    return succ


def successor_write_eat(entry_rank, entry_eat_rank, entry_key, entry_status,
                        entry_kind) -> torch.Tensor:
    """succ_w for the conflict index: the per-entry half of the transitive
    elision, shared by the plain version and the CUDA deps tile (which, like
    the JAX package's Pallas tile, takes it as an input)."""
    committed = (entry_status >= _COMMITTED) & (entry_status <= _APPLIED) \
        & (entry_rank >= 0)
    is_write = ((WRITE_KIND_MASK >> entry_kind) & 1) == 1
    write_eat = torch.where(committed & is_write, entry_eat_rank, _BIG)
    return _successor_write_eat(entry_key, entry_eat_rank, write_eat)


def shard_width(touches: torch.Tensor, n_shards: int) -> int:
    """Ks, the keys of each shard's block in touches [B, S*Ks]."""
    if n_shards <= 0 or touches.shape[1] % n_shards:
        raise ValueError(f"touches' {touches.shape[1]} columns do not split "
                         f"into {n_shards} shards' key blocks")
    return touches.shape[1] // n_shards


def sharded_successor_write_eat(entry_rank, entry_eat_rank, entry_key,
                                entry_status, entry_kind, ks: int
                                ) -> torch.Tensor:
    """succ_w for S shards' conflict indexes at once: [S, E] arrays whose
    keys are local to their shard's block of `ks` keys -> [S, E].  The keys
    are offset by s * ks before the one sort, so no two shards' keys ever
    share a segment: each entry's successor is its own shard's, as when
    every device of the mesh computes it on its own block."""
    offset = ks * torch.arange(entry_key.shape[0], dtype=entry_key.dtype,
                               device=entry_key.device)[:, None]
    flat = (a.reshape(-1) for a in (entry_rank, entry_eat_rank,
                                    entry_key + offset, entry_status,
                                    entry_kind))
    return successor_write_eat(*flat).reshape(entry_key.shape)


def deps_tile(touches, entry_key, entry_rank, entry_eat_rank, entry_status,
              entry_kind, succ_w, txn_rank, txn_witness_mask):
    """The [B, E] tile given succ_w: the function the CUDA deps tile
    computes.  -> (dep_mask[B, E] bool, dep_count[B] i32)."""
    touch_e = touches[:, entry_key]                              # [B, E] gather
    earlier = entry_rank[None, :] < txn_rank[:, None]
    witnessed = ((txn_witness_mask[:, None] >> entry_kind[None, :]) & 1) == 1
    active = (entry_rank >= 0) \
        & (entry_status > _TRANSITIVELY_KNOWN) \
        & (entry_status != STATUS_INACTIVE)
    base = touch_e & earlier & witnessed & active[None, :]

    # transitive elision: e is covered iff a committed write at its key
    # executes strictly between e and the querying txn; the earliest such
    # write is txn-independent (succ_w), leaving a broadcast compare
    committed = (entry_status >= _COMMITTED) & (entry_status <= _APPLIED) \
        & (entry_rank >= 0)
    strictly_above = succ_w > entry_eat_rank  # tie-guard; eats unique per key
    elided = (committed & strictly_above)[None, :] \
        & (succ_w[None, :] < txn_rank[:, None])

    dep = base & ~elided
    return dep, dep.sum(dim=1, dtype=torch.int32)


def sharded_deps_tile(touches, entry_key, entry_rank, entry_eat_rank,
                      entry_status, entry_kind, succ_w, txn_rank,
                      txn_witness_mask):
    """The tile over S shards in the key-block layout (touches [B, S*Ks],
    [S, E] entry arrays with local keys): ``deps_tile`` shard by shard, as
    each device of the JAX mesh runs it, with the counts summed (the psum
    over 'shard').  -> (dep_mask[S, B, E] bool, dep_count[B] i32)."""
    n = entry_key.shape[0]
    ks = shard_width(touches, n)
    masks, counts = zip(*(
        deps_tile(touches[:, i * ks:(i + 1) * ks], entry_key[i],
                  entry_rank[i], entry_eat_rank[i], entry_status[i],
                  entry_kind[i], succ_w[i], txn_rank, txn_witness_mask)
        for i in range(n)))
    return torch.stack(masks), torch.stack(counts).sum(0, dtype=torch.int32)


def batched_active_deps(entry_rank, entry_eat_rank, entry_key, entry_status,
                        entry_kind, txn_rank, txn_witness_mask, touches):
    """-> (dep_mask[B, E] bool, dep_count[B] i32 — per-(txn,key) edges)."""
    succ_w = successor_write_eat(entry_rank, entry_eat_rank, entry_key,
                                 entry_status, entry_kind)
    return deps_tile(touches, entry_key, entry_rank, entry_eat_rank,
                     entry_status, entry_kind, succ_w, txn_rank,
                     txn_witness_mask)


def in_batch_graph(txn_rank, txn_witness_mask, txn_kind, touches):
    """In-window conflict graph for the wavefront resolver.

    dep_bb[b, b'] = txns share a key & rank(b') < rank(b) & b witnesses b'.
    The key-sharing test is touches @ touches.T in f32, tested > 0: the
    inputs are 0/1 and the sums integers below 2^24, so it is exact (an
    int8 product would wrap on the CPU)."""
    tf = touches.to(torch.float32)
    shared = (tf @ tf.T) > 0
    return conflict_edges(shared, txn_rank, txn_witness_mask, txn_kind)


def conflict_edges(shared, txn_rank, txn_witness_mask, txn_kind):
    """Mask a key-sharing matrix down to directed conflict edges: b' earlier
    than b, b's kind witnesses b', both rows valid."""
    earlier = txn_rank[None, :] < txn_rank[:, None]
    witnessed = ((txn_witness_mask[:, None] >> txn_kind[None, :]) & 1) == 1
    valid = txn_rank >= 0
    return shared & earlier & witnessed & valid[None, :] & valid[:, None]
