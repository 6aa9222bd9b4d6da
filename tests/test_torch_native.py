"""The port's native C++ tier against its Python tier and the JAX package's.

``accord_tpu_torch/native/`` builds three extensions with g++ at first use:
the sorted-array merges and searches with the checkpoint-interval capsule,
the CommandsForKey core, and the wire frame codec.  Each must give exactly
what the port's pure-Python tier gives, and what the JAX package's native
tier gives, on the same seeded inputs: merges and searches (as
tests/test_native.py), the interval index's stabs and overlaps, seeded CFK
op tapes (tests/test_cfk_native.py's randomized tapes, condensed: every
array, version, missing[] and scan after every op), and one frame carrying
every registered verb, byte for byte (as tests/test_wire_roundtrip.py).
Both packages' extensions export the same module names, so each package
must load the libraries built beside its own sources.  Outputs are
compared as plain tuples, with ==.  The ``slow`` case checks in fresh
interpreters that ``ACCORD_NO_NATIVE=1`` selects the Python tier for all
three and ``ACCORD_NATIVE=0`` for the CFK core alone.
"""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from accord_tpu import native as jax_native
from accord_tpu.local import cfk as jax_cfk
from accord_tpu.primitives import keys as jax_keys
from accord_tpu.primitives import timestamp as jax_ts
from accord_tpu.utils import checkpoint_intervals as jax_ci
from accord_tpu_torch import native as port_native
from accord_tpu_torch.local import cfk as port_cfk
from accord_tpu_torch.primitives import keys as port_keys
from accord_tpu_torch.primitives import timestamp as port_ts
from accord_tpu_torch.utils import checkpoint_intervals as port_ci
from accord_tpu_torch.utils import sorted_arrays as port_sa

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _both_native_tiers_built():
    """g++ is part of this repository's toolchain: both packages must have
    built all three extensions, so no comparison below is skipped."""
    for pkg in (port_native, jax_native):
        assert pkg.get() is not None and pkg.get_cfk() is not None \
            and pkg.get_wire() is not None, f"{pkg.__name__}: no native tier"


def _plain(x):
    """A value of either package as plain tuples and ints."""
    if isinstance(x, (port_ts.Timestamp, jax_ts.Timestamp)):
        return (x.epoch, x.hlc, x.flags, x.node)
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if hasattr(x, "value") and not isinstance(x, (int, str)):
        return int(x.value)  # an enum member
    return x


def _sorted_unique(rng, n, hi=60):
    return sorted(set(rng.randrange(hi) for _ in range(n)))


def test_sorted_arrays_and_intervals_native_match_python_and_reference(
        monkeypatch):
    """Union, intersection, subtract, the n-way merge and binary search:
    the port's native module == its Python bodies == the JAX package's
    native module, on ints and on TxnIds; the identity-return and
    out-of-bounds conventions; the package binds the native tier.  Then
    the checkpoint-interval index (CINTIA): stabs and overlaps through the
    native capsule == the Python checkpoints == the JAX package's capsule
    == brute force; tokens wider than int64 fall back to the Python tier in
    both packages."""
    pn, jn = port_native.get(), jax_native.get()
    assert port_sa.linear_union is pn.linear_union
    assert port_sa.linear_merge_n is pn.linear_merge_n
    rng = random.Random(3)
    for _ in range(300):
        a = _sorted_unique(rng, rng.randrange(25))
        b = _sorted_unique(rng, rng.randrange(25))
        for name in ("linear_union", "linear_intersection",
                     "linear_subtract"):
            got = getattr(pn, name)(a, b)
            assert got == getattr(port_sa, f"py_{name}")(a, b), name
            assert got == getattr(jn, name)(a, b), name
        lists = [_sorted_unique(rng, rng.randrange(12))
                 for _ in range(rng.randrange(6))]
        assert pn.linear_merge_n(lists) == port_sa.py_linear_merge_n(lists) \
            == jn.linear_merge_n(lists)
    for ts in (port_ts, jax_ts):
        ids = sorted(ts.TxnId.create(1, h, ts.TxnKind.WRITE, ts.Domain.KEY,
                                     h % 3)
                     for h in random.Random(4).sample(range(500), 40))
        a, b = ids[::2], ids[::3]
        mod = pn if ts is port_ts else jn
        assert mod.linear_union(a, b) == sorted(set(a) | set(b))
        assert mod.linear_intersection(a, b) == sorted(set(a) & set(b))
        assert mod.linear_merge_n([a, b, ids[1::5]]) == \
            sorted(set(a) | set(b) | set(ids[1::5]))
    xs = [2, 4, 6, 8, 11]
    for target in range(13):
        for lo in range(len(xs)):
            for hi in (None, lo, len(xs)):
                want = port_sa.py_binary_search(xs, target, lo, hi)
                assert pn.binary_search(xs, target, lo, hi) == want
                assert jn.binary_search(xs, target, lo, hi) == want
    a = [1, 2, 3]
    assert pn.linear_union(a, []) is a and pn.linear_union([], a) is a
    assert pn.linear_merge_n([]) == [] == pn.linear_merge_n([[], []])
    for mod in (pn, jn):
        with pytest.raises(IndexError):
            mod.binary_search([1, 2, 3], 9, 0, 1000)

    rng = random.Random(5)
    cases = []
    for _ in range(40):
        n = rng.randint(0, 40)
        starts = sorted(rng.randint(0, 100) for _ in range(n))
        ends = [s + 1 + rng.randint(0, 30) for s in starts]
        lo = rng.randint(0, 100)
        cases.append((starts, ends, lo, lo + rng.randint(1, 40)))

    def run(ci, native_on):
        if not native_on:
            monkeypatch.setattr(ci, "_native_mod", None)
        out = []
        for starts, ends, lo, hi in cases:
            idx = ci.CheckpointIntervalIndex(starts, ends, every=4)
            assert (idx._capsule is not None) == native_on
            for point in (0, 5, 50, 99, 131):
                got = []
                idx.find(point, got.append)
                out.append(got)
            got = []
            idx.find_overlaps(lo, hi, got.append)
            out.append(got)
        monkeypatch.undo()
        return out

    native = run(port_ci, True)
    assert native == run(port_ci, False) == run(jax_ci, True)
    want = []
    for starts, ends, lo, hi in cases:
        want += [port_ci.CheckpointIntervalIndex.brute(starts, ends, p)
                 for p in (0, 5, 50, 99, 131)]
        want.append([i for i in range(len(starts))
                     if starts[i] < hi and ends[i] > lo])
    assert native == want
    big = 1 << 70
    for ci in (port_ci, jax_ci):
        idx = ci.CheckpointIntervalIndex([0, big], [big + 1, big + 2],
                                         every=1)
        got = []
        idx.find(big, got.append)
        assert idx._capsule is None and got == [0, 1]


def _cfk_tape(seed, n_ops=140, pool_size=48, hlc_span=500):
    """One seeded CFK op tape in plain ints (tests/test_cfk_native.py's
    generator), replayable in either package."""
    rng = random.Random(seed)
    kinds = ("READ", "WRITE", "SYNC_POINT", "EXCLUSIVE_SYNC_POINT")
    n_status = len(port_cfk.InternalStatus)
    pool = [(100 + rng.randrange(hlc_span), rng.choice(kinds),
             rng.randrange(4)) for _ in range(pool_size)]
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        tid = rng.randrange(pool_size)
        if r < 0.50:
            st = rng.randrange(n_status)
            eat = None
            if rng.random() < 0.5:
                eat = (pool[tid][0] + rng.randrange(60), pool[tid][2])
            deps = None
            if rng.random() < 0.8:
                deps = tuple(rng.sample(range(pool_size),
                                        rng.randrange(0, 14)))
            ops.append(("update", tid, st, eat, deps))
        elif r < 0.62:
            ops.append(("hist", tid))
        elif r < 0.72:
            ops.append(("prune", rng.randrange(pool_size)))
        elif r < 0.82:
            ops.append(("unmanaged", tid, (100 + rng.randrange(hlc_span + 80),
                                           rng.randrange(4))))
        else:
            ops.append(("scan", (100 + rng.randrange(hlc_span + 60),
                                 rng.randrange(4)), rng.choice(kinds)))
    return pool, ops


def _replay_cfk(cfk_mod, keys_mod, ts, tape, native_on):
    """Run `tape` on a fresh CommandsForKey of one package and tier -> every
    output and the whole state after every op, as plain tuples."""
    pool, ops = tape
    ids = [ts.TxnId.create(1, hlc, ts.TxnKind[kind], ts.Domain.KEY, node)
           for hlc, kind, node in pool]
    statuses = list(cfk_mod.InternalStatus)
    saved = cfk_mod._NATIVE
    cfk_mod._NATIVE = saved if native_on else None
    try:
        cfk = cfk_mod.CommandsForKey(keys_mod.Key(1))
        trace = []
        for op in ops:
            if op[0] == "update":
                _, i, st, eat, deps = op
                status = statuses[st]
                eat_ts = ts.Timestamp(1, eat[0], 0, eat[1]) \
                    if eat is not None else None
                dep_ids = [ids[d] for d in deps] \
                    if deps is not None and status.has_info else None
                fired = cfk.update(ids[i], status, eat_ts, dep_ids=dep_ids)
                out = ("fired", [u.txn_id for u in fired])
            elif op[0] == "hist":
                cfk.register_historical(ids[op[1]])
                out = ("hist",)
            elif op[0] == "prune":
                fired = cfk.prune_redundant(ids[op[1]])
                out = ("pruned", [u.txn_id for u in fired])
            elif op[0] == "unmanaged":
                _, i, (hlc, node) = op
                until = ts.Timestamp(1, hlc, 0, node)
                unmanaged = cfk_mod.Unmanaged
                out = ("unmanaged", False)
                if cfk.blocking_ids(unmanaged.APPLY, until, exclude=ids[i],
                                    first_only=True):
                    cfk.register_unmanaged(unmanaged(
                        ids[i], unmanaged.APPLY, until, lambda safe: None))
                    out = ("unmanaged", True)
            else:
                _, (hlc, node), kind = op
                got = []
                cfk.map_reduce_active(ts.Timestamp(1, hlc, 0, node),
                                      ts.TxnKind[kind].witnesses(),
                                      got.append)
                out = ("scan", got)
            trace.append(_plain((
                out, list(cfk._ids), [int(s) for s in cfk._status],
                list(cfk._eat), list(cfk._missing), list(cfk._wdeps),
                list(cfk._committed), cfk.version, cfk.committed_version,
                cfk.redundant_before,
                sorted(w[2].txn_id for w in cfk._wait_heap))))
        return trace
    finally:
        cfk_mod._NATIVE = saved


def test_cfk_op_tapes_native_matches_python_and_reference():
    """30 seeded op tapes and 10 dense same-hlc ones (updates with dep ids,
    historical registrations, pruning, unmanaged waits, scans): after every
    op the port's native core == its Python tier == the JAX package's
    native core, in the output, the arrays, missing[], wdeps, the
    committed view, the versions and the pending waits."""
    assert port_cfk._NATIVE is port_native.get_cfk() is not None
    tapes = [_cfk_tape(seed) for seed in range(30)]
    tapes += [_cfk_tape(1000 + seed, n_ops=180, pool_size=16, hlc_span=30)
              for seed in range(10)]
    scans = 0
    for tape in tapes:
        native = _replay_cfk(port_cfk, port_keys, port_ts, tape, True)
        assert native == _replay_cfk(port_cfk, port_keys, port_ts, tape,
                                     False)
        assert native == _replay_cfk(jax_cfk, jax_keys, jax_ts, tape, True)
        scans += sum(1 for step in native if step[0][0] == "scan"
                     and step[0][1])
    assert scans > 50, "the tapes' scans found almost nothing"


def test_wire_frame_of_every_verb_byte_identical_across_tiers():
    """One coalesced frame carrying every registered verb (the hostile
    burn's harvest and the synthesized rest, tests/test_wire_roundtrip.py's
    sources) packs to the same bytes through the JAX package's Python and
    native tiers; decoded by the port into its own message objects, it packs
    to those bytes again through the port's Python and native tiers, and
    the port's one-pass native decode gives canonically the same messages."""
    from accord_tpu.host import wire as jax_wire
    from accord_tpu.messages.base import MessageType as JaxMessageType
    from accord_tpu.sim.burn import BurnRun
    from accord_tpu_torch.host import wire as port_wire
    from accord_tpu_torch.journal.snapshot import canonical_encoding
    from accord_tpu_torch.messages.base import MessageType
    from tests.test_wire_roundtrip import (UNEMITTED, _coalesced_frame, _Gen,
                                           _synthesize)

    assert port_wire.codec_tier() == "native"
    # tests/test_wire_roundtrip.py's hostile burn, at 60 ops: with the
    # synthesizers it still carries every verb (asserted below)
    run = BurnRun(3, 60, drop_prob=0.08, partitions=True, clock_drift=True,
                  range_every=4)
    captured = []
    net = run.cluster.network
    orig_req, orig_rep = net.deliver_request, net.deliver_reply

    def cap_req(f, t, r, c):
        captured.append(r)
        return orig_req(f, t, r, c)

    def cap_rep(f, t, m, r):
        captured.append(r)
        return orig_rep(f, t, m, r)

    net.deliver_request, net.deliver_reply = cap_req, cap_rep
    run.run()
    for nid in run.cluster.nodes:
        captured.extend(run.cluster.journal.for_node(nid))
    by_verb = {}
    for msg in captured + _synthesize(_Gen(4000)):
        mt = getattr(msg, "type", None)
        if mt is not None:
            by_verb.setdefault(mt.name, msg)
    want = {mt.name for mt in JaxMessageType} - UNEMITTED
    assert want == {mt.name for mt in MessageType} - UNEMITTED
    assert not want - set(by_verb), sorted(want - set(by_verb))

    frame = _coalesced_frame([by_verb[name] for name in sorted(want)])
    out = bytearray()
    jax_wire._py_pack_value(frame, out)
    ref_bytes = bytes(out)
    jax_wire._native_codec()  # binds the JAX package's object packer
    assert jax_native.get_wire().wire_pack(frame) == ref_bytes

    tree = port_wire.py_unpack(ref_bytes)
    port_frame = dict(tree, m=[
        dict(body, payload=port_wire.decode_message(body["payload"]))
        for body in tree["m"]])
    assert [type(b["payload"]).__name__ for b in port_frame["m"]] == \
        [type(by_verb[name]).__name__ for name in sorted(want)]
    out = bytearray()
    port_wire._py_pack_value(port_frame, out)
    assert bytes(out) == ref_bytes
    port_wire_mod = port_native.get_wire()
    assert port_wire_mod.wire_pack(port_frame) == ref_bytes
    assert port_wire_mod.wire_unpack(ref_bytes) == tree
    objs = port_wire_mod.wire_unpack_obj(ref_bytes)
    for got, body in zip(objs["m"], port_frame["m"]):
        assert type(got["payload"]) is type(body["payload"])
        assert canonical_encoding(got["payload"]) == \
            canonical_encoding(body["payload"])


def test_each_package_loads_its_own_library():
    """Both packages' extensions export the same module names
    (``PyInit__accord_native``, ``_accord_cfk``, ``_accord_wire``); in one
    interpreter each package must still reach the library built beside its
    own sources, not the other package's."""
    for pkg in (port_native, jax_native):
        here = Path(pkg.__file__).resolve().parent
        for mod in (pkg.get(), pkg.get_cfk(), pkg.get_wire()):
            assert Path(mod.__file__).resolve().parent == here, \
                (pkg.__name__, mod.__file__)
    for get in ("get", "get_cfk", "get_wire"):
        assert getattr(port_native, get)() is not getattr(jax_native, get)()
    assert port_cfk._NATIVE is port_native.get_cfk()
    assert jax_cfk._NATIVE is jax_native.get_cfk()
    assert port_sa.linear_union is port_native.get().linear_union


@pytest.mark.slow
def test_no_native_switch_selects_the_python_tier():
    """In a fresh interpreter, ACCORD_NO_NATIVE=1 leaves all three
    extensions unbuilt and unloaded (the port's modules run their Python
    tiers), and ACCORD_NATIVE=0 turns off the CFK core alone."""
    code = (
        "import json\n"
        "from accord_tpu_torch import native\n"
        "from accord_tpu_torch.host import wire\n"
        "from accord_tpu_torch.local import cfk\n"
        "from accord_tpu_torch.utils import checkpoint_intervals as ci\n"
        "from accord_tpu_torch.utils import sorted_arrays as sa\n"
        "idx = ci.CheckpointIntervalIndex([0, 5], [9, 7], every=1)\n"
        "print(json.dumps([native.AVAILABLE, native.get() is None,\n"
        "    native.get_cfk() is None, native.get_wire() is None,\n"
        "    wire.codec_tier(), cfk._NATIVE is None,\n"
        "    sa.linear_union is sa.py_linear_union, idx._capsule is None]))\n")

    def tiers(**env):
        full = {k: v for k, v in os.environ.items()
                if k not in ("ACCORD_NO_NATIVE", "ACCORD_NATIVE")}
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env={**full, **env}, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout.strip().splitlines()[-1])

    assert tiers(ACCORD_NO_NATIVE="1") == \
        [False, True, True, True, "python", True, True, True]
    assert tiers(ACCORD_NATIVE="0") == \
        [True, False, True, False, "native", True, False, False]
    assert tiers() == [True, False, False, False, "native", False, False,
                       False]
