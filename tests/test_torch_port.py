"""The port's slice against the JAX package, on the CPU.

The copied host modules (randomness, timestamps, the per-key conflict index,
the encoder, the benchmark world) must build the same windows from the same
seeds, and the port's resolve_step must give the JAX resolve_step's four
outputs (and the Pallas step's, run in interpret mode) exactly: every output
is integer or boolean, so the tolerance is ==.  Also: importing the port
never loads jax or accord_tpu, and its entry points refuse to run without a
CUDA card unless the CPU is asked for.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from accord_tpu.ops import BatchEncoder as JaxEncoder
from accord_tpu.ops import resolve_step as jax_resolve_step
from accord_tpu.ops.encode import scalar_deps_oracle as jax_scalar_deps_oracle
from accord_tpu.primitives import timestamp as jax_ts
from accord_tpu.utils.random_source import RandomSource as JaxRandom
from accord_tpu_torch import entry as port_entry
from accord_tpu_torch import workload
from accord_tpu_torch.ops import encode as port_encode
from accord_tpu_torch.ops import resolve_step
from accord_tpu_torch.primitives import timestamp as port_ts
from accord_tpu_torch.utils import backend
from accord_tpu_torch.utils.random_source import RandomSource as PortRandom
from tests.test_ops import random_world as jax_random_world

REPO = Path(__file__).resolve().parent.parent
STATE = ("entry_rank", "entry_eat_rank", "entry_key", "entry_status",
         "entry_kind")
BATCH = ("txn_rank", "txn_witness_mask", "txn_kind", "touches")


def _ids(ts_list):
    return [(t.epoch, t.hlc, t.flags, t.node) for t in ts_list]


def _worlds(seed, **kw):
    """The same random world built by each package from one seed."""
    return (jax_random_world(JaxRandom(seed), **kw),
            workload.random_world(PortRandom(seed), **kw))


def _assert_same_encoding(jax_world, port_world):
    je, pe = JaxEncoder(*jax_world), port_encode.BatchEncoder(*port_world)
    for f in STATE:
        assert np.array_equal(getattr(pe.state, f), getattr(je.state, f)), f
    for f in BATCH:
        assert np.array_equal(getattr(pe.dbatch, f), getattr(je.dbatch, f)), f
    assert (pe.state.num_entries, pe.state.num_keys, pe.dbatch.num_txns) == \
        (je.state.num_entries, je.state.num_keys, je.dbatch.num_txns)
    assert _ids(pe.universe) == _ids(je.universe)
    return je, pe


def test_random_source_gives_the_same_stream():
    a, b = JaxRandom(1234), PortRandom(1234)
    xs = list(range(50))
    for _ in range(200):
        assert a.next_int(7) == b.next_int(7)
        assert a.next_int(3, 90) == b.next_int(3, 90)
        assert a.next_float() == b.next_float()
        assert a.pick(xs) == b.pick(xs)
        assert a.sample(xs, 4) == b.sample(xs, 4)
    assert a.fork().next_long() == b.fork().next_long()


def test_timestamp_order_and_witnesses_match_jax():
    rng = np.random.default_rng(5)
    kinds = [1, 2, 3, 4, 5, 6]
    raw = [(int(rng.integers(1, 3)), int(rng.integers(0, 40)),
            int(rng.choice(kinds)), int(rng.integers(0, 2)),
            int(rng.integers(0, 4))) for _ in range(300)]
    jx = [jax_ts.TxnId.create(e, h, jax_ts.TxnKind(k), jax_ts.Domain(d), n)
          for e, h, k, d, n in raw]
    pt = [port_ts.TxnId.create(e, h, port_ts.TxnKind(k), port_ts.Domain(d), n)
          for e, h, k, d, n in raw]
    assert _ids(sorted(pt)) == _ids(sorted(jx))
    for a, b in zip(jx[:40], jx[40:80]):
        pa = port_ts.TxnId(a.epoch, a.hlc, a.flags, a.node)
        pb = port_ts.TxnId(b.epoch, b.hlc, b.flags, b.node)
        assert pa.witnesses(pb) == a.witnesses(b)
    for k in kinds:
        assert sorted(map(int, port_ts.TxnKind(k).witnesses())) == \
            sorted(map(int, jax_ts.TxnKind(k).witnesses()))
    assert port_encode.WRITE_KIND_MASK == \
        sum(1 << int(k) for k in jax_ts.TxnKind if k.is_write)


@pytest.mark.parametrize("seed", range(3))
def test_cfk_and_encoder_match_jax_on_random_world(seed):
    """Same seed -> same per-key conflict indexes (ids, statuses, executeAts,
    missing[]), same encoder arrays, same scalar deps oracle."""
    (jc, jb), (pc, pb) = _worlds(seed)
    for j, p in zip(jc, pc):
        ji, js, je, jm = j.as_arrays()
        pi, ps, pe, pm = p.as_arrays()
        assert _ids(pi) == _ids(ji)
        assert list(map(int, ps)) == list(map(int, js))
        assert _ids(pe) == _ids(je)
        assert [_ids(m) for m in pm] == [_ids(m) for m in jm]
    _assert_same_encoding((jc, jb), (pc, pb))
    want = [_ids(r) for r in jax_scalar_deps_oracle(jc, jb)]
    assert [_ids(r) for r in port_encode.scalar_deps_oracle(pc, pb)] == want


def test_build_world_matches_jax_bench():
    """A small benchmark world: same encoding, oracle and scalar edges."""
    kw = dict(n_keys=64, n_existing=600, n_batch=96, seed=42)
    jw, pw = bench.build_world(**kw), workload.build_world(**kw)
    _assert_same_encoding(jw, pw)
    assert [_ids(r) for r in port_encode.scalar_deps_oracle(*pw)] == \
        [_ids(r) for r in jax_scalar_deps_oracle(*jw)]
    assert workload.scalar_edges_per_sec(*pw)[1] == \
        bench.scalar_edges_per_sec(*jw)[1]


@pytest.mark.parametrize("seed", range(3))
def test_resolve_step_matches_jax(seed):
    jw, pw = _worlds(400 + seed, n_keys=16, n_existing=80, n_batch=24)
    je = JaxEncoder(*jw)
    want = jax_resolve_step(*(getattr(je.state, f) for f in STATE),
                            *(getattr(je.dbatch, f) for f in BATCH))
    pe = port_encode.BatchEncoder(*pw)
    got = resolve_step(*port_encode.window_to_tensors(pe.state, pe.dbatch,
                                                      "cpu"))
    for g, w, dtype in zip(got, want, (torch.bool, torch.int32, torch.bool,
                                       torch.int32)):
        assert g.dtype == dtype
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert [_ids(r) for r in pe.decode_deps(got[0].numpy())] == \
        [_ids(r) for r in jax_scalar_deps_oracle(*jw)]


def test_resolve_step_matches_pallas_interpret():
    """The port's step == the JAX package's Pallas step (K1 -> graph -> K2)
    run in interpret mode, as tests/test_pallas.py runs it."""
    from accord_tpu.ops import resolve_step_pallas
    jw = jax_random_world(JaxRandom(700), n_keys=10, n_existing=40,
                          n_batch=12)
    je = JaxEncoder(*jw)
    args = tuple(getattr(je.state, f) for f in STATE) + \
        tuple(getattr(je.dbatch, f) for f in BATCH)
    want = resolve_step_pallas(*args, interpret=True)
    got = resolve_step(*port_encode.window_to_tensors(args, None, "cpu"))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_window_to_tensors_takes_both_forms():
    je = JaxEncoder(*jax_random_world(JaxRandom(3)))
    nine = tuple(getattr(je.state, f) for f in STATE) + \
        tuple(getattr(je.dbatch, f) for f in BATCH)
    a = port_encode.window_to_tensors(je.state, je.dbatch, "cpu")
    b = port_encode.window_to_tensors(nine, None, torch.device("cpu"))
    assert len(a) == len(b) == 9
    for x, y, src in zip(a, b, nine):
        assert torch.equal(x, y) and x.device.type == "cpu"
        assert x.dtype == (torch.bool if src.dtype == bool else torch.int32)
        assert np.array_equal(x.numpy(), src)
    with pytest.raises(ValueError, match="nine"):
        port_encode.window_to_tensors(nine[:8], None, "cpu")


def test_entry_matches_graft_entry_on_cpu():
    import __graft_entry__
    jfn, jargs = __graft_entry__.entry()
    fn, args = port_entry.entry(device="cpu")
    for a, ja in zip(args, jargs):
        assert np.array_equal(a.numpy(), ja)
    for g, w in zip(fn(*args), jfn(*jargs)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_entry_points_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_encode.window_to_tensors(np.zeros((9, 1), np.int32))
    assert backend.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_accord_tpu():
    """In a fresh interpreter (this one has jax loaded by conftest), every
    module of the port imports without loading jax or accord_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import accord_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'accord_tpu'))\n"
        "need = {'accord_tpu_torch.bench', 'accord_tpu_torch.ops.range_kernel',"
        " 'accord_tpu_torch.ops.recovery_kernel',"
        " 'accord_tpu_torch.impl.device_store',"
        " 'accord_tpu_torch.local.commands', 'accord_tpu_torch.local.store'}\n"
        "print(len(names), bad, sorted(need - set(names)))\n"
        "sys.exit(1 if bad or need - set(names) or len(names) < 46 else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    # chip_smoke.py imports the port inside main(): check its source
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "accord_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "accord_tpu"}
