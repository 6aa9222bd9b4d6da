"""Batched recovery scans in PyTorch.

The counterpart of ``accord_tpu/ops/recovery_kernel.py``.  The reference's
recovery voting round computes four per-key predicates per BeginRecovery,
each a full scan of the conflict index testing the missing[] divergence
encoding (CommandsForKey.mapReduceFull, reference
accord/local/CommandsForKey.java:553-612, driven by
messages/BeginRecovery.java:104-190):

  * rejects-fast-path (a): an ACCEPTED/COMMITTED txn started after ours,
    proposed to execute after us, whose deps omit us;
  * rejects-fast-path (b): a STABLE/APPLIED txn executing after us whose
    deps omit us;
  * earlier-committed-witness: stable txns started before us that DID
    witness us;
  * earlier-accepted-no-witness: proposed txns started before us, executing
    after us, whose deps omit us (recovery must await their commit).

All four share one [B, E] mask algebra over the rank encoding.  The missing[]
membership test (the scalar scan's inner bisect) is ONE searchsorted: each
(entry, missing-id) pair is coded as ``entry_index * R + missing_rank`` into a
single sorted vector, and probe b's membership at entry e is a hit for
``e * R + rank(b)``.  The "is the probe witnessed at this key" gate of the
WITH-dep query is an equality-presence matmul.

In the JAX package this function lies outside Pallas, so here it is plain
PyTorch on either device: CUDA tensors in, CUDA tensors out.  Its scalar
oracle is the raw enumeration of ``local/cfk.py``'s four scans.
``RecoveryEncoder`` is a copy of the JAX package's (numpy only).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from accord_tpu_torch.ops.encode import _pad_to
from accord_tpu_torch.primitives.keys import Key
from accord_tpu_torch.primitives.timestamp import TxnId
from accord_tpu_torch.utils.backend import resolve_device

# InternalStatus bands (accord_tpu_torch.local.cfk.InternalStatus)
_ACCEPTED = 3
_COMMITTED = 4
_STABLE = 5
_APPLIED = 6


def batched_recovery_scans(entry_rank, entry_eat_rank, entry_key,
                           entry_status, entry_kind, missing_code, probe_rank,
                           probe_wb_mask, touches, rank_count: int):
    """int32 [E] entry vectors, the sorted int32 missing codes, int32 [B]
    probe vectors and touches [B, K] bool -> four [B, E] bool masks
    (rejects-started-after, rejects-executes-after, committed-witness,
    accepted-no-witness).  Callers fold the reject masks with any(); keeping
    them per-entry lets a serving store answer over any SUBSET of a probe's
    keys."""
    e = entry_rank.shape[0]
    ek = entry_key.to(torch.int64)
    touch_e = touches[:, ek]                                      # [B, E]
    valid = entry_rank >= 0
    not_self = entry_rank[None, :] != probe_rank[:, None]
    witnessed_kind = ((probe_wb_mask[:, None] >> entry_kind[None, :]) & 1) == 1
    proposed = (entry_status == _ACCEPTED) | (entry_status == _COMMITTED)
    stable_band = (entry_status >= _STABLE) & (entry_status <= _APPLIED)
    has_info = (entry_status >= _ACCEPTED) & (entry_status <= _APPLIED)
    eat_gt = entry_eat_rank[None, :] > probe_rank[:, None]

    # missing[] membership: one searchsorted over the coded pairs (the
    # encoder guarantees missing_code is non-empty — sentinel -1 pad — and
    # that codes fit int32)
    codes = (torch.arange(e, dtype=torch.int32, device=entry_rank.device)
             [None, :] * rank_count + probe_rank[:, None])        # [B, E]
    flat = codes.reshape(-1)
    idx = torch.searchsorted(missing_code, flat, right=False)
    idx = idx.clamp(0, missing_code.shape[0] - 1)
    in_missing = (missing_code[idx] == flat).reshape(codes.shape)  # [B, E]

    # probe known at entry's key: presence matmul over (rank==, key) pairs;
    # 0/1 inputs, sums <= E < 2^24, so f32 is exact
    k = touches.shape[1]
    eqm = (entry_rank[None, :] == probe_rank[:, None]) & valid[None, :]
    onehot_key = (ek[:, None] == torch.arange(
        k, device=ek.device)[None, :]).to(torch.float32)         # [E, K]
    known_at_key = torch.matmul(eqm.to(torch.float32), onehot_key) > 0
    known = known_at_key[:, ek]                                   # [B, E]

    dep_without = has_info[None, :] & eat_gt & in_missing
    dep_with = has_info[None, :] & eat_gt & ~in_missing & known

    started_before = entry_rank[None, :] < probe_rank[:, None]
    started_after = entry_rank[None, :] > probe_rank[:, None]
    base = touch_e & not_self & witnessed_kind & valid[None, :] \
        & (probe_rank >= 0)[:, None]

    rejects_a = base & started_after & proposed[None, :] & dep_without
    rejects_b = base & stable_band[None, :] & dep_without
    committed_witness = base & started_before & stable_band[None, :] & dep_with
    accepted_no_witness = base & started_before & proposed[None, :] \
        & dep_without
    return rejects_a, rejects_b, committed_witness, accepted_no_witness


class RecoveryEncoder:
    """Encodes CFK state + a batch of recovery probes for the scans.

    Reuses the rank-universe discipline of ops/encode.py: every TxnId and
    executeAt is mapped to a dense rank; missing[] collections become the
    sorted coded vector `entry_index * R + missing_rank`."""

    def __init__(self, cfks, probes: Sequence[Tuple[TxnId, Sequence[Key]]],
                 pad: int = 128):
        self.probes = list(probes)
        self.keys: List[Key] = sorted({c.key for c in cfks}
                                      | {k for _, ks in probes for k in ks})
        self.key_index = {key: i for i, key in enumerate(self.keys)}
        ts = set(tid for tid, _ in probes)
        entries = []
        missing_lists = []
        for cfk in cfks:
            ki = self.key_index[cfk.key]
            ids, statuses, eats, missing = cfk.as_arrays()
            for tid, status, eat, m in zip(ids, statuses, eats, missing):
                ts.add(tid)
                ts.add(eat)
                ts.update(m)
                entries.append((ki, tid, int(status), eat))
                missing_lists.append(m)
        self.universe = sorted(ts)
        self.rank = {t: i for i, t in enumerate(self.universe)}
        self.rank_count = max(1, len(self.universe))
        self.entries = entries

        e = _pad_to(max(1, len(entries)), pad)
        self.entry_rank = np.full(e, -1, np.int32)
        self.entry_eat_rank = np.full(e, -1, np.int32)
        self.entry_key = np.zeros(e, np.int32)
        self.entry_status = np.full(e, 7, np.int32)  # INVALID_OR_TRUNCATED
        self.entry_kind = np.zeros(e, np.int32)
        # codes must fit int32: entry_index * R + rank.  torch wraps int32
        # silently, so this assert is the only guard.  Worlds beyond ~2^31
        # pairs stay on the scalar path.
        assert e * self.rank_count < (1 << 31), \
            "recovery-scan world too large for int32 codes"
        codes: List[int] = []
        for i, ((ki, tid, status, eat), m) in enumerate(
                zip(entries, missing_lists)):
            self.entry_rank[i] = self.rank[tid]
            self.entry_eat_rank[i] = self.rank[eat]
            self.entry_key[i] = ki
            self.entry_status[i] = status
            self.entry_kind[i] = int(tid.kind)
            for mid in m:
                codes.append(i * self.rank_count + self.rank[mid])
        codes.sort()
        # sentinel -1 keeps the array non-empty; probe codes are >= 0
        self.missing_code = np.asarray([-1] + codes, np.int32)

        b = _pad_to(max(1, len(probes)), pad)
        kpad = _pad_to(max(1, len(self.keys)), pad)
        self.probe_rank = np.full(b, -1, np.int32)
        self.probe_wb_mask = np.zeros(b, np.int32)
        self.touches = np.zeros((b, kpad), bool)
        for i, (tid, ks) in enumerate(probes):
            self.probe_rank[i] = self.rank[tid]
            mask = 0
            for kk in tid.kind.witnessed_by():
                mask |= 1 << int(kk)
            self.probe_wb_mask[i] = mask
            for key in ks:
                self.touches[i, self.key_index[key]] = True

    def args(self):
        return (self.entry_rank, self.entry_eat_rank, self.entry_key,
                self.entry_status, self.entry_kind, self.missing_code,
                self.probe_rank, self.probe_wb_mask, self.touches,
                self.rank_count)

    def tensors(self, device=None):
        """``args()`` on `device` (None means the CUDA card, see
        ``utils.backend.resolve_device``): nine contiguous tensors, int32
        except the bool touches, then the rank count."""
        dev = resolve_device(device)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in self.args()[:9]) + (self.rank_count,)

    def decode_ids(self, mask_row: np.ndarray) -> List[TxnId]:
        """One probe's [E] mask -> sorted unique TxnIds."""
        return sorted({self.entries[e][1]
                       for e in np.nonzero(mask_row[:len(self.entries)])[0]})

    def decode_keyed(self, mask_row: np.ndarray) -> Dict[Key, List[TxnId]]:
        """One probe's [E] mask -> {key: sorted ids} (for per-key serving)."""
        out: Dict[Key, List[TxnId]] = {}
        for e in np.nonzero(mask_row[:len(self.entries)])[0]:
            ki, tid, _status, _eat = self.entries[e]
            out.setdefault(self.keys[ki], []).append(tid)
        return {k: sorted(v) for k, v in out.items()}


def scalar_predicates(cfks, probe: TxnId, keys) -> tuple:
    """The four per-probe predicates from the scalar scans, unioned over the
    probe's keys as BeginRecovery folds per-key scans -> (rejects_a bool,
    rejects_b bool, sorted witness ids, sorted no-witness ids): what the
    batched masks give after folding the rejects with any() and decoding the
    two id lists."""
    by_key = {c.key: c for c in cfks}
    rejects_a = rejects_b = False
    witness, no_witness = set(), set()
    for k in keys:
        cfk = by_key[k]
        rejects_a |= bool(cfk.started_after_without_witnessing_ids(
            probe, raw=True))
        rejects_b |= bool(cfk.executes_after_without_witnessing_ids(
            probe, raw=True))
        witness.update(cfk.stable_started_before_and_witnessed(probe))
        no_witness.update(cfk.accepted_started_before_without_witnessing(probe))
    return rejects_a, rejects_b, sorted(witness), sorted(no_witness)
