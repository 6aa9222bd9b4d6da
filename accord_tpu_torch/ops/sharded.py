"""The resolve step, single-device and mesh-sharded.

The counterpart of ``accord_tpu/ops/sharded.py``.  ``resolve_step`` is its
single-device pipeline and, on CUDA tensors, the counterpart of
``pallas_kernels.resolve_step_pallas``: the deps tile (K1), the in-window
conflict graph, and the wavefront (K2) for one flush window.

The sharded step keeps the reference's layout.  Accord shards its replica
state by key range over CommandStores (reference
accord/local/CommandStores.java:78, ShardDistributor.EvenSplit
ShardDistributor.java:46), and the JAX package's mesh axis 'shard'
partitions the key axis, and with it the conflict-index entry axis:
  - each shard computes dependency edges only for its own key block
    (dep_mask stays per shard, like PartialDeps);
  - the per-txn counts are summed over the shards (the psum, the cross-shard
    Deps.merge of reference primitives/Deps.java:256);
  - the in-window conflict graph is the sum of per-shard key-sharing
    products, after which every shard runs the identical wavefront.
The shard axis takes two forms here.  Stacked, on one device: the [S, ...]
arrays go through one succ_w pass and ONE K1 launch pair for all S shards
(the psum is K1's own sum into one count vector), and the graph is one f32
product over all S*Ks key columns, which equals the sum of the per-shard
products.  Across cards: with a list of D devices, one process drives
every card, as the JAX store drives its mesh from one controller; card d
holds the contiguous block of S/D shards d*S/D .. (d+1)*S/D - 1
(``shard_to_devices``) and runs the stacked form on it, and an NCCL
all-reduce over one tensor a card (``all_reduce_sum``) takes the place of
the psums.  Distributed: with a ``torch.distributed`` group of S ranks,
rank r computes shard r, and ``all_reduce(SUM)`` takes the place of the
psums.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from accord_tpu_torch.local.cfk import CommandsForKey
from accord_tpu_torch.ops.cuda_kernels import (batched_active_deps_cuda,
                                               execution_waves_cuda)
from accord_tpu_torch.ops.deps_kernel import (conflict_edges, in_batch_graph,
                                              shard_width)
from accord_tpu_torch.ops.encode import (STATUS_INACTIVE, _pad_to,
                                         collect_universe, kinds_mask,
                                         witness_mask)
from accord_tpu_torch.primitives.keys import Key
from accord_tpu_torch.primitives.timestamp import TxnId
from accord_tpu_torch.utils.backend import resolve_devices


def resolve_step(entry_rank, entry_eat_rank, entry_key, entry_status,
                 entry_kind, txn_rank, txn_witness_mask, txn_kind, touches):
    """deps + in-window graph + waves -> (dep_mask[B, E] bool,
    dep_count[B] i32, dep_bb[B, B] bool, waves[B] i32).

    On CUDA tensors the deps tile and the wavefront run as the hand-written
    kernels and the graph as one f32 matmul; on CPU tensors every step runs
    its plain PyTorch version.  The wavefront is given the ranks, whose
    order makes the graph's edges point backwards: its forward pass."""
    dep_mask, dep_count = batched_active_deps_cuda(
        entry_rank, entry_eat_rank, entry_key, entry_status, entry_kind,
        txn_rank, txn_witness_mask, touches)
    dep_bb = in_batch_graph(txn_rank, txn_witness_mask, txn_kind, touches)
    waves = execution_waves_cuda(dep_bb, txn_rank)
    return dep_mask, dep_count, dep_bb, waves


def _shard_deps(n_shards, group, entries, txn_rank, txn_witness_mask,
                touches):
    """The deps half of a sharded step on the stacked arguments: on one
    device all S shards, in a group rank r's shard r alone (the slice
    shard_map's in_specs give it).  -> (dep_mask, the count before the
    all-reduce, the touches of the shards computed here)."""
    if any(a.dim() != 2 or a.shape[0] != n_shards for a in entries):
        raise ValueError(f"expected [S, E] entry arrays for {n_shards} "
                         f"shards, got {[tuple(a.shape) for a in entries]}")
    ks = shard_width(touches, n_shards)
    if group is not None:
        r = dist.get_rank(group)
        entries = tuple(a[r:r + 1] for a in entries)
        touches = touches[:, r * ks:(r + 1) * ks].contiguous()
    dep_mask, dep_count = batched_active_deps_cuda(
        *entries, txn_rank, txn_witness_mask, touches)
    return dep_mask, dep_count, touches


def _check_group(n_shards: int, group, devices) -> None:
    if group is not None and devices is not None:
        raise ValueError("a sharded step takes a group or a list of "
                         "devices, not both")
    if group is not None and dist.get_world_size(group) != n_shards:
        raise ValueError(f"a sharded step over {n_shards} shards needs a "
                         f"group of {n_shards} ranks, got "
                         f"{dist.get_world_size(group)}")


def _blocks(n_shards: int, devices) -> int:
    """S/D, the shards of each device's block; D must divide S."""
    if n_shards % len(devices):
        raise ValueError(f"{n_shards} shards do not split evenly over "
                         f"{len(devices)} devices")
    return n_shards // len(devices)


def shard_to_devices(args, n_shards: int, devices) -> List[tuple]:
    """The stacked arguments of a sharded step (the nine of
    ``ShardedEncoder.args()``, or the deps step's eight: entry arrays
    [S, Es] first, touches [B, S*Ks] last, the txn arrays between; numpy
    arrays or tensors on any device) -> one tuple of the same arguments a
    device of `devices`: device d gets the entry rows and the touches'
    columns of its contiguous block of S/D shards, and the txn arrays
    whole.  Each block is copied from where it lies straight to its
    device."""
    devices = resolve_devices(devices)
    per = _blocks(n_shards, devices)
    arrays = [torch.from_numpy(np.ascontiguousarray(a))
              if isinstance(a, np.ndarray) else a for a in args]
    entries, txn, touches = arrays[:5], arrays[5:-1], arrays[-1]
    if any(a.dim() != 2 or a.shape[0] != n_shards for a in entries):
        raise ValueError(f"expected [S, E] entry arrays for {n_shards} "
                         f"shards, got {[tuple(a.shape) for a in entries]}")
    ks = shard_width(touches, n_shards)
    placed = []
    for d, dev in enumerate(devices):
        lo, hi = d * per, (d + 1) * per
        block = ([a[lo:hi] for a in entries] + txn
                 + [touches[:, lo * ks:hi * ks]])
        placed.append(tuple(a.contiguous().to(dev) for a in block))
    return placed


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum one tensor a device into every one of them, in place: the psum
    of a step over several devices.  On CUDA tensors, one on each of
    distinct cards, an NCCL all-reduce on each card's current stream (so
    it follows the work queued there before it, and what is queued after
    it follows the sum), with no host sync; a failure raises.  On CPU
    tensors its plain version, ``torch.stack(tensors).sum(0)``.  ->
    `tensors`."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        total = torch.stack(list(tensors)).sum(0, dtype=tensors[0].dtype)
        for t in tensors:
            t.copy_(total)
        return list(tensors)
    from torch.cuda import nccl
    if kinds != {"cuda"} or not nccl.is_available(tensors):
        raise RuntimeError(
            f"an NCCL all-reduce needs one contiguous CUDA tensor on each of "
            f"distinct cards in a torch built with NCCL, got "
            f"{[str(t.device) for t in tensors]}")
    nccl.all_reduce(list(tensors), streams=[
        torch.cuda.current_stream(t.device) for t in tensors])
    return list(tensors)


def dep_mask_to_host(dep_mask) -> np.ndarray:
    """A sharded step's dep_mask -> numpy [S, B, Es]: the stacked tensor
    copied to the host, or, from a step over several devices, each
    device's plane copied straight to the host and the planes joined in
    shard order (``decode_deps`` and ``decode_key_deps`` read either)."""
    if isinstance(dep_mask, torch.Tensor):
        return dep_mask.cpu().numpy()
    return np.concatenate([m.cpu().numpy() for m in dep_mask])


class _DevicesStep:
    """A sharded step over a list of devices (``make_sharded_step`` and
    ``make_sharded_deps_step`` with `devices`): called on the stacked
    arguments, it places them with ``shard_to_devices``; ``run`` takes
    them placed already."""

    def __init__(self, n_shards: int, devices, graph: bool):
        self.devices = resolve_devices(devices)
        self.n_shards = n_shards
        self.per = _blocks(n_shards, self.devices)
        self.graph = graph

    def __call__(self, *args):
        return self.run(shard_to_devices(args, self.n_shards, self.devices))

    def run(self, placed):
        """`placed`: ``shard_to_devices``'s tuples, one a device.  Every
        device's launches are queued before any sum, so the cards run
        together."""
        if [a[0].device for a in placed] != self.devices:
            raise ValueError(f"arguments placed on "
                             f"{[str(a[0].device) for a in placed]}, the "
                             f"step runs on {self.devices}")
        masks, counts, shared = [], [], []
        for args in placed:
            mask, count, touches = _shard_deps(
                self.per, None, args[:5], args[5], args[6], args[-1])
            masks.append(mask)
            counts.append(count)
            if self.graph:
                tf = touches.to(torch.float32)
                shared.append(tf @ tf.T)
        dep_count = all_reduce_sum(counts)[0]
        if not self.graph:
            return tuple(masks), dep_count
        shared = all_reduce_sum(shared)[0]
        txn_rank, txn_witness_mask, txn_kind = placed[0][5:8]
        dep_bb = conflict_edges(shared > 0, txn_rank, txn_witness_mask,
                                txn_kind)
        return (tuple(masks), dep_count, dep_bb,
                execution_waves_cuda(dep_bb, txn_rank))


def make_sharded_step(n_shards: int, group=None, devices=None):
    """The sharded pipeline over `n_shards` key blocks: a callable of the
    nine arrays in ``ShardedEncoder.args()`` order (entry arrays [S, Es]
    with local keys, touches [B, S*Ks]) -> (dep_mask[S, B, Es] bool,
    dep_count[B] i32, dep_bb[B, B] bool, waves[B] i32), the outputs of the
    JAX ``make_sharded_step``.

    With `group` None the shards are a stacked axis on the arguments'
    device: on CUDA tensors one K1 launch pair and one K2 launch a step,
    whatever S; on CPU tensors the plain versions.  With `group`, a
    ``torch.distributed`` group of `n_shards` ranks that the caller made,
    each rank passes the same stacked arguments, computes its own shard and
    returns its own dep_mask[r][None]; ``all_reduce(SUM)`` combines the
    counts and the key-sharing counts, and every rank then runs the graph's
    masks and the wavefront, so dep_count, dep_bb and waves agree on every
    rank.

    With `devices` (a list, or "all": ``utils.backend.resolve_devices``),
    device d runs the stacked form on its block of S/D shards (on the card
    one K6 and one stacked K1 launch a card, and its block's key-sharing
    product); ``all_reduce_sum`` (NCCL on the cards) sums the counts and
    the products, and the graph's masks and K2 run once, on devices[0].
    -> (dep_mask, a tuple of the devices' [S/D, B, Es] planes in shard
    order, each left on its device (``dep_mask_to_host`` joins them);
    dep_count, dep_bb, waves on devices[0]).  The callable's ``run`` takes
    ``shard_to_devices``'s placement instead of the stacked arguments."""
    _check_group(n_shards, group, devices)
    if devices is not None:
        return _DevicesStep(n_shards, devices, graph=True)

    def step(entry_rank, entry_eat_rank, entry_key, entry_status,
             entry_kind, txn_rank, txn_witness_mask, txn_kind, touches):
        dep_mask, dep_count, touches = _shard_deps(
            n_shards, group, (entry_rank, entry_eat_rank, entry_key,
                              entry_status, entry_kind),
            txn_rank, txn_witness_mask, touches)
        # key-sharing counts of 0/1 inputs: integers below 2^24, exact in f32
        tf = touches.to(torch.float32)
        shared = tf @ tf.T
        if group is not None:
            dist.all_reduce(dep_count, group=group)
            dist.all_reduce(shared, group=group)
        dep_bb = conflict_edges(shared > 0, txn_rank, txn_witness_mask,
                                txn_kind)
        waves = execution_waves_cuda(dep_bb, txn_rank)
        return dep_mask, dep_count, dep_bb, waves

    return step


def make_sharded_deps_step(n_shards: int, group=None, devices=None):
    """The deps half of ``make_sharded_step`` for the device store's flush
    windows: a callable of the eight arrays of ``ShardedEncoder.args()``
    without txn_kind -> (dep_mask[S, B, Es] bool, dep_count[B] i32), with
    no graph and no wavefront (deps probes are txn-agnostic scans; the
    store plans execution apart).  `group` and `devices` as in
    ``make_sharded_step``: with `devices`, dep_mask is the tuple of the
    devices' planes and dep_count lies on devices[0]."""
    _check_group(n_shards, group, devices)
    if devices is not None:
        return _DevicesStep(n_shards, devices, graph=False)

    def step(entry_rank, entry_eat_rank, entry_key, entry_status,
             entry_kind, txn_rank, txn_witness_mask, touches):
        dep_mask, dep_count, _ = _shard_deps(
            n_shards, group, (entry_rank, entry_eat_rank, entry_key,
                              entry_status, entry_kind),
            txn_rank, txn_witness_mask, touches)
        if group is not None:
            dist.all_reduce(dep_count, group=group)
        return dep_mask, dep_count

    return step


class ShardedEncoder:
    """Key-block layout for the sharded step (a copy of the JAX package's).

    Keys are range-partitioned into `n_shards` contiguous blocks of the
    sorted key universe (the EvenSplit policy); each shard's keys and
    conflict-index entries are padded to uniform Ks/Es so the stacked arrays
    are rectangular.  Ranks come from one global universe so cross-shard
    comparisons agree bit-for-bit with the host order.
    """

    def __init__(self, cfks: Sequence[CommandsForKey],
                 batch: Sequence[Tuple[TxnId, Sequence[Key]]],
                 n_shards: int, pad: int = 8):
        self._init(cfks, batch,
                   [(tid, witness_mask(tid.kind), int(tid.kind), ks)
                    for tid, ks in batch], n_shards, pad)

    @classmethod
    def for_probes(cls, cfks: Sequence[CommandsForKey], probes,
                   n_shards: int, pad: int = 8) -> "ShardedEncoder":
        """Encode deps probes — (before, witness KindSet, keys) — instead of
        new txns (the same txn-agnostic probe contract as
        BatchEncoder.for_probes; the device store's flush windows use it)."""
        self = cls.__new__(cls)
        self._init(cfks, probes,
                   [(before, kinds_mask(kinds), 0, ks)
                    for before, kinds, ks in probes], n_shards, pad)
        return self

    def _init(self, cfks, batch, rows, n_shards: int, pad: int) -> None:
        self.n_shards = n_shards
        self.batch = list(batch)
        keys = sorted({c.key for c in cfks}
                      | {k for _, _, _, ks in rows for k in ks})
        per_key: Dict[Key, CommandsForKey] = {c.key: c for c in cfks}
        self.universe, self.rank = collect_universe(
            cfks, [ts for ts, _, _, _ in rows])

        # contiguous key blocks
        blocks: List[List[Key]] = [[] for _ in range(n_shards)]
        per = (len(keys) + n_shards - 1) // max(1, n_shards) if keys else 0
        for i, k in enumerate(keys):
            blocks[min(i // max(1, per), n_shards - 1) if per else 0].append(k)
        self.blocks = blocks
        ks = _pad_to(max([1] + [len(b) for b in blocks]), pad)
        entries_per: List[List[Tuple[int, TxnId, int, object]]] = []
        for s in range(n_shards):
            es: List[Tuple[int, TxnId, int, object]] = []
            for li, k in enumerate(blocks[s]):
                cfk = per_key.get(k)
                if cfk is None:
                    continue
                ids, statuses, eats, _missing = cfk.as_arrays()
                for tid, status, eat in zip(ids, statuses, eats):
                    es.append((li, tid, int(status), eat))
            entries_per.append(es)
        es_pad = _pad_to(max([1] + [len(e) for e in entries_per]), pad)

        S = n_shards
        self.entry_rank = np.full((S, es_pad), -1, np.int32)
        self.entry_eat_rank = np.full((S, es_pad), -1, np.int32)
        self.entry_key = np.zeros((S, es_pad), np.int32)
        self.entry_status = np.full((S, es_pad), STATUS_INACTIVE, np.int32)
        self.entry_kind = np.zeros((S, es_pad), np.int32)
        self.entries_per = entries_per
        for s, es in enumerate(entries_per):
            for i, (li, tid, status, eat) in enumerate(es):
                self.entry_rank[s, i] = self.rank[tid]
                self.entry_eat_rank[s, i] = self.rank[eat]
                self.entry_key[s, i] = li
                self.entry_status[s, i] = status
                self.entry_kind[s, i] = int(tid.kind)

        b = _pad_to(max(1, len(rows)), pad)
        self.txn_rank = np.full(b, -1, np.int32)
        self.txn_witness_mask = np.zeros(b, np.int32)
        self.txn_kind = np.zeros(b, np.int32)
        self.touches = np.zeros((b, S * ks), bool)
        self.ks = ks
        key_slot: Dict[Key, int] = {}
        for s, blk in enumerate(blocks):
            for li, k in enumerate(blk):
                key_slot[k] = s * ks + li
        for i, (ts, wmask, kind, keyset) in enumerate(rows):
            self.txn_rank[i] = self.rank[ts]
            self.txn_witness_mask[i] = wmask
            self.txn_kind[i] = kind
            for k in keyset:
                self.touches[i, key_slot[k]] = True

    def args(self):
        """The nine numpy arrays in ``make_sharded_step`` order
        (``encode.window_to_tensors(enc.args(), device=...)`` puts them on a
        device); the deps step takes them without txn_kind, the eighth."""
        return (self.entry_rank, self.entry_eat_rank, self.entry_key,
                self.entry_status, self.entry_kind, self.txn_rank,
                self.txn_witness_mask, self.txn_kind, self.touches)

    def decode_deps(self, dep_mask: np.ndarray) -> List[List[TxnId]]:
        """[S, B, Es] stacked shard outputs -> per-batch-txn sorted unique
        dependency TxnIds."""
        out: List[List[TxnId]] = []
        for b in range(len(self.batch)):
            ids = set()
            for s, es in enumerate(self.entries_per):
                row = dep_mask[s, b]
                for e in np.nonzero(row[:len(es)])[0]:
                    ids.add(es[e][1])
            out.append(sorted(ids))
        return out

    def decode_key_deps(self, dep_mask: np.ndarray
                        ) -> List[Dict[Key, List[TxnId]]]:
        """[S, B, Es] -> per-probe {key: sorted dep ids} maps (the device
        store's serving format, mirroring BatchEncoder.decode_key_deps)."""
        out: List[Dict[Key, List[TxnId]]] = []
        for b in range(len(self.batch)):
            m: Dict[Key, List[TxnId]] = {}
            for s, es in enumerate(self.entries_per):
                row = dep_mask[s, b]
                for e in np.nonzero(row[:len(es)])[0]:
                    li, tid, _, _ = es[e]
                    m.setdefault(self.blocks[s][li], []).append(tid)
            out.append({k: sorted(v) for k, v in m.items()})
        return out
