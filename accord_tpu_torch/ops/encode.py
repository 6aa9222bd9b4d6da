"""Host <-> device encoding for the batched kernels.

The device never sees 128-bit timestamps.  The host assembles the *universe*
of Timestamps relevant to a batch window (every TxnId in the per-key conflict
indexes, every distinct executeAt, plus the batch's own ids), sorts it with
full Timestamp order (epoch, hlc, flags, node — accord_tpu_torch.primitives
.timestamp), and ships dense int32 *ranks*.  Rank comparison on device is
then bit-identical to Timestamp comparison on host, which is what makes the
device path provably equivalent to the scalar scans (reference
CommandsForKey.java:614-650 iterates ids in exactly this sorted order, and
elides by executeAt against the max committed write).

Layouts (all padded to lane multiples, pad entries are inert):
  DeviceState  — one row per (key, txn) conflict-index entry:
      entry_rank[E] i32     (TxnId rank; -1 = pad)
      entry_eat_rank[E] i32 (executeAt-or-txnId rank)
      entry_key[E] i32, entry_status[E] i32, entry_kind[E] i32
  DeviceBatch  — one row per new transaction in the window:
      txn_rank[B] i32, txn_witness_mask[B] i32 (bit k = witnesses TxnKind k),
      touches[B, K] bool

A copy of ``accord_tpu/ops/encode.py`` over the port's own primitives, plus
``window_to_tensors``, which carries an encoded window onto a torch device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from accord_tpu_torch import native
from accord_tpu_torch.utils.backend import resolve_device
from accord_tpu_torch.local.cfk import CommandsForKey, InternalStatus
from accord_tpu_torch.primitives.keys import Key
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId, TxnKind

PAD = 128
STATUS_INACTIVE = int(InternalStatus.INVALID_OR_TRUNCATED)
# Bit k set <=> TxnKind(k).is_write — the transitive-elision bound counts
# committed EXCLUSIVE_SYNC_POINTs as writes, exactly like the host scan
# (cfk.max_committed_write_before).  Derived from the property so the device
# predicate has a single source of truth.
WRITE_KIND_MASK = sum(1 << int(k) for k in TxnKind if k.is_write)
# bit k set <=> k is a TxnKind: the native encoder raises on an id whose
# kind bits are not one, as TxnId.kind does
_KIND_BITS = sum(1 << int(k) for k in TxnKind)


def _pad_to(n: int, pad: int) -> int:
    return max(pad, ((n + pad - 1) // pad) * pad)


class DeviceState:
    """Dense encoding of a set of per-key conflict indexes."""

    __slots__ = ("entry_rank", "entry_eat_rank", "entry_key", "entry_status",
                 "entry_kind", "num_entries", "num_keys")

    def __init__(self, entry_rank: np.ndarray, entry_eat_rank: np.ndarray,
                 entry_key: np.ndarray, entry_status: np.ndarray,
                 entry_kind: np.ndarray, num_entries: int, num_keys: int):
        self.entry_rank = entry_rank
        self.entry_eat_rank = entry_eat_rank
        self.entry_key = entry_key
        self.entry_status = entry_status
        self.entry_kind = entry_kind
        self.num_entries = num_entries
        self.num_keys = num_keys


class DeviceBatch:
    """Dense encoding of a window of new transactions."""

    __slots__ = ("txn_rank", "txn_witness_mask", "txn_kind", "touches",
                 "num_txns")

    def __init__(self, txn_rank: np.ndarray, txn_witness_mask: np.ndarray,
                 txn_kind: np.ndarray, touches: np.ndarray, num_txns: int):
        self.txn_rank = txn_rank
        self.txn_witness_mask = txn_witness_mask
        self.txn_kind = txn_kind
        self.touches = touches
        self.num_txns = num_txns


def kinds_mask(kinds) -> int:
    """Pack a KindSet into the device's bitmask encoding."""
    mask = 0
    for k in kinds:
        mask |= 1 << int(k)
    return mask


def witness_mask(kind: TxnKind) -> int:
    return kinds_mask(kind.witnesses())


def collect_universe(cfks: Sequence[CommandsForKey],
                     batch_ids: Sequence[TxnId]):
    """The sorted Timestamp universe for one window: every entry id, every
    distinct executeAt, every batch id. Returns (universe, rank)."""
    ts = set(batch_ids)
    for cfk in cfks:
        ids, _status, eats, _missing = cfk.as_arrays()
        ts.update(ids)
        ts.update(eats)
    universe = sorted(ts)
    return universe, {t: i for i, t in enumerate(universe)}


class BatchEncoder:
    """Encodes one flush window: conflict-index state + new txns -> arrays.

    Also the decoder: dependency masks come back as [B, E] booleans over the
    same entry universe and are translated to sorted TxnId lists.
    """

    def __init__(self, cfks: Sequence[CommandsForKey],
                 batch: Sequence[Tuple[TxnId, Sequence[Key]]],
                 pad: int = PAD):
        self._init(cfks, batch,
                   [(tid, witness_mask(tid.kind), int(tid.kind), ks)
                    for tid, ks in batch], pad)

    @classmethod
    def for_probes(cls, cfks: Sequence[CommandsForKey],
                   probes: Sequence[Tuple[Timestamp, object, Sequence[Key]]],
                   pad: int = PAD) -> "BatchEncoder":
        """Encode deps *probes* — (before, witness KindSet, keys) — instead
        of new txns.  The active scan is txn-agnostic: its result depends
        only on the rank bound, the kind mask, and the keys (callers filter
        their own id afterwards, commands.calculate_deps), so one probe can
        serve any query with the same (before, kinds)."""
        self = cls.__new__(cls)
        self._init(cfks, probes,
                   [(before, kinds_mask(kinds), 0, ks)
                    for before, kinds, ks in probes], pad)
        return self

    def _init(self, cfks, batch, rows, pad: int) -> None:
        """Shared window setup: `rows` = (timestamp, wmask, kind, keys) per
        batch item — the only place the two constructors differ."""
        self.pad = pad
        cfks = list(cfks)
        # the key universe, sorted by token as Key orders and hashes (and
        # Keys sorts): for each token the first Key seen, the CFKs' keys
        # before the rows'
        by_token: Dict[int, Key] = {}
        for c in cfks:
            by_token.setdefault(c.key.token, c.key)
        for _, _, _, ks in rows:
            for k in ks:
                by_token.setdefault(k.token, k)
        tokens = sorted(by_token)
        self.keys: List[Key] = [by_token[t] for t in tokens]
        column = {t: i for i, t in enumerate(tokens)}
        self.batch = list(batch)
        # the decoder's flat TxnId column: entry e's id, CFK after CFK
        self.entry_ids: List[TxnId] = []
        for cfk in cfks:
            self.entry_ids.extend(cfk._ids)
        n = len(self.entry_ids)
        e = _pad_to(max(1, n), self.pad)
        self.state = DeviceState(
            np.full(e, -1, np.int32), np.full(e, -1, np.int32),
            np.zeros(e, np.int32), np.full(e, STATUS_INACTIVE, np.int32),
            np.zeros(e, np.int32), n, len(self.keys))
        txn_rank = np.full(_pad_to(max(1, len(rows)), self.pad), -1, np.int32)
        batch_ts = [ts for ts, _, _, _ in rows]
        key_cols = [column[c.key.token] for c in cfks]
        core = native.get_cfk()
        self.tier = "python" if core is None else "native"
        if core is None:
            self._encode_python(cfks, key_cols, batch_ts, txn_rank)
        else:
            s = self.state
            self.universe = core.encode_window(
                cfks, key_cols, batch_ts, _KIND_BITS, s.entry_rank,
                s.entry_eat_rank, s.entry_key, s.entry_status, s.entry_kind,
                txn_rank)
            self._rank = None
        self._encode_batch(rows, txn_rank, column)

    @property
    def rank(self) -> Dict[Timestamp, int]:
        """{Timestamp: its index in the universe}, built when first read."""
        if self._rank is None:
            self._rank = {t: i for i, t in enumerate(self.universe)}
        return self._rank

    def _encode_python(self, cfks: Sequence[CommandsForKey],
                       key_cols: Sequence[int], batch_ts: Sequence[Timestamp],
                       txn_rank: np.ndarray) -> None:
        """The Python tier of the entry columns and the batch's ranks:
        bit-identical to the native core's ``encode_window``."""
        self.universe, self._rank = collect_universe(cfks, batch_ts)
        rank, s = self._rank, self.state
        i = 0
        for cfk, ki in zip(cfks, key_cols):
            ids, statuses, eats, _missing = cfk.as_arrays()
            for tid, status, eat in zip(ids, statuses, eats):
                s.entry_rank[i] = rank[tid]
                s.entry_eat_rank[i] = rank[eat]
                s.entry_key[i] = ki
                s.entry_status[i] = int(status)
                s.entry_kind[i] = int(tid.kind)
                i += 1
        for i, ts in enumerate(batch_ts):
            txn_rank[i] = rank[ts]

    def _encode_batch(self, rows: Sequence[Tuple[Timestamp, int, int,
                                                 Sequence[Key]]],
                      txn_rank: np.ndarray, column: Dict[int, int]) -> None:
        b = len(txn_rank)
        k = _pad_to(max(1, len(self.keys)), self.pad)
        txn_wmask = np.zeros(b, np.int32)
        txn_kind = np.zeros(b, np.int32)
        touches = np.zeros((b, k), bool)
        for i, (_ts, wmask, kind, _ks) in enumerate(rows):
            txn_wmask[i] = wmask
            txn_kind[i] = kind
        touches[[i for i, (_, _, _, ks) in enumerate(rows) for _ in ks],
                [column[k.token] for _, _, _, ks in rows for k in ks]] = True
        self.dbatch = DeviceBatch(txn_rank, txn_wmask, txn_kind, touches,
                                  len(rows))

    # -- decode --
    def decode_deps(self, dep_mask: np.ndarray) -> List[List[TxnId]]:
        """[B, E] bool -> per-batch-txn sorted unique dependency TxnIds."""
        out: List[List[TxnId]] = []
        ids, n = self.entry_ids, self.state.num_entries
        for b in range(len(self.batch)):
            row = dep_mask[b]
            out.append(sorted({ids[e] for e in np.nonzero(row[:n])[0]}))
        return out

    def decode_key_deps(self, dep_mask: np.ndarray
                        ) -> List[Dict[Key, List[TxnId]]]:
        """[B, E] bool -> per-batch-txn {key: sorted dep ids} maps."""
        out: List[Dict[Key, List[TxnId]]] = []
        ids, keys = self.entry_ids, self.keys
        n, entry_key = self.state.num_entries, self.state.entry_key
        for b in range(len(self.batch)):
            m: Dict[Key, List[TxnId]] = {}
            nz = np.nonzero(dep_mask[b][:n])[0]
            for e, ki in zip(nz.tolist(), entry_key[nz].tolist()):
                m.setdefault(keys[ki], []).append(ids[e])
            out.append({k: sorted(v) for k, v in m.items()})
        return out


def scalar_deps_oracle(cfks: Sequence[CommandsForKey],
                       batch: Sequence[Tuple[TxnId, Sequence[Key]]]
                       ) -> List[List[TxnId]]:
    """The host oracle the device path must match bit-for-bit: per-txn deps
    via the scalar map_reduce_active scan with pruning on, exactly as the
    protocol path runs it (CommandsForKey.java:614-650).  Shared by the
    equivalence tests and chip_smoke.py so there is one copy of the
    contract."""
    by_key = {c.key: c for c in cfks}
    out: List[List[TxnId]] = []
    for tid, keyset in batch:
        ids: set = set()
        for k in keyset:
            by_key[k].map_reduce_active(tid, tid.kind.witnesses(), ids.add)
        out.append(sorted(ids))
    return out


_STATE_FIELDS = ("entry_rank", "entry_eat_rank", "entry_key", "entry_status",
                 "entry_kind")
_BATCH_FIELDS = ("txn_rank", "txn_witness_mask", "txn_kind")


def window_to_tensors(state, batch=None, device=None
                      ) -> Tuple[torch.Tensor, ...]:
    """An encoded window -> the nine ``resolve_step`` arguments on `device`.

    `state` and `batch` are duck-typed: anything with the DeviceState and
    DeviceBatch attributes (this module's encoders, or the JAX package's,
    as numpy arrays).  Alternatively `state` is the nine arrays in
    ``resolve_step`` order and `batch` is None.  Integer arrays become int32
    tensors and ``touches`` a bool tensor.  `device` None means the CUDA card
    (see ``utils.backend.resolve_device``)."""
    dev = resolve_device(device)
    if batch is None:
        arrays = tuple(state)
        if len(arrays) != 9:
            raise ValueError(f"expected the nine resolve_step arrays, "
                             f"got {len(arrays)}")
    else:
        arrays = (tuple(getattr(state, f) for f in _STATE_FIELDS)
                  + tuple(getattr(batch, f) for f in _BATCH_FIELDS)
                  + (batch.touches,))
    ints = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
            for a in arrays[:8]]
    touches = torch.from_numpy(np.ascontiguousarray(arrays[8], dtype=bool))
    return tuple(t.to(dev) for t in ints + [touches])
