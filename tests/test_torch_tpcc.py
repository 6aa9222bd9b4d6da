"""The port's TPC-C replay lane and key-set window kernel against the JAX
package, on the CPU.

The plain K4 (ops/keyset.py::keyset_windows) must be == to the Pallas kernel
``keyset_windows_pallas`` run in interpret mode, as tests/test_pallas.py
runs it; one window, one stack and the whole lane (accord_tpu_torch/tpcc.py)
must be == to ``bench.py``'s ``_tpcc_resolve_core``, ``_tpcc_stack_fn`` and
``bench_tpcc``.  Every output is an integer: the tolerance is ==.
"""

import json

import numpy as np
import pytest
import torch

import bench
from accord_tpu.ops.pallas_kernels import keyset_windows_pallas
from accord_tpu_torch import tpcc
from accord_tpu_torch.ops import cuda_kernels, keyset
from accord_tpu_torch.workload import keyset_cases, large_keyset_window


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pallas_inputs(seed):
    """tests/test_pallas.py:116-121: W=3, B=128, P=11, keys from 60 values
    with 10% padding anywhere, window 1's last 7 rows padded."""
    rng = np.random.default_rng(900 + seed)
    W, B, P = 3, 128, 11
    tk = np.where(rng.random((W, B, P)) < 0.9,
                  rng.integers(0, 60, (W, B, P)), -1).astype(np.int32)
    tr = np.tile(np.arange(B, dtype=np.int32), (W, 1))
    tr[1, -7:] = -1
    return tk, tr


def _random_window(rng, b, p, domain):
    """Unsorted, repeated keys, negative pads anywhere, permuted ranks with
    padded rows."""
    tk = np.where(rng.random((b, p)) < 0.8, rng.integers(0, domain, (b, p)),
                  rng.integers(-3, 0, (b, p))).astype(np.int32)
    tr = rng.permutation(b).astype(np.int32)
    tr[rng.random(b) < 0.1] = -1
    return tk, tr


@pytest.mark.parametrize("seed", range(3))
def test_keyset_windows_matches_pallas_interpret(seed):
    tk, tr = _pallas_inputs(seed)
    got = keyset.keyset_windows(_t(tk), _t(tr))
    for reps in (1, 3):
        want = keyset_windows_pallas(tk, tr, interpret=True, reps=reps)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", range(6))
def test_keyset_windows_edge_cases(case):
    """The windows a sparse key-to-rows kernel can get wrong (tied ranks,
    keys at 0 and 2**31-1, all rows padded, one key in every row, P = 1,
    P = 5): plain == Pallas interpret == window_oracle."""
    label, tk, tr = keyset_cases()[case]
    got = keyset.keyset_windows(_t(tk), _t(tr))
    want = keyset_windows_pallas(tk, tr, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w)), label
    assert tpcc.window_oracle(tk[0], tr[0]) == (int(got[0][0]),
                                                int(got[1][0])), label


@pytest.fixture
def one_thread():
    """Dense [B, B] products on one thread, so a large case does not crowd
    the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_keyset_windows_large_window_matches_pallas_interpret(one_thread):
    """A window above K4's shared-memory range (B = 1200, P = 20: 24,000 key
    slots, 20 keys a row), which the card runs in K4's large-window kernel:
    plain == Pallas interpret == window_oracle."""
    label, tk, tr = large_keyset_window(1200, 20)
    got = keyset.keyset_windows(_t(tk), _t(tr))
    want = keyset_windows_pallas(tk, tr, interpret=True)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), label
    assert tpcc.window_oracle(tk[0], tr[0]) == (int(got[0][0]),
                                                int(got[1][0])), label
    assert int(got[0][0]) > 0 and int(got[1][0]) > 1


def test_resolve_window_matches_jax_core():
    """Three lane windows (the last one short, with padded rows), each
    resolved as a one-window stack: cross-window deps, in-window edges and
    max wave == bench._tpcc_resolve_core's dep counts summed, edges and
    max wave."""
    core = bench._tpcc_resolve_core()
    windows = tpcc.tpcc_windows(tpcc.tpcc_keys(1400, 2, 3), 256)
    for prev, rank, keys in (windows[0], windows[3], windows[-1]):
        dep_count, in_edges, max_wave = map(np.asarray, core(prev, rank, keys))
        got = tpcc.resolve_stack(_t(prev[None]), _t(rank[None]),
                                 _t(keys[None]))
        assert all(g.dtype == torch.int32 for g in got)
        assert [int(g) for g in got] == [int(dep_count.sum()), int(in_edges),
                                         int(max_wave)]
        assert int(got[1]) > 0


def test_resolve_stack_matches_jax_stack():
    """One K bucket: cross-window deps, in-window edges and max wave ==
    bench._tpcc_stack_fn on its XLA path at reps = 1."""
    windows = tpcc.tpcc_windows(tpcc.tpcc_keys(2000, 3, 8), 256)
    for stack in tpcc.stack_buckets(windows):
        want = np.asarray(bench._tpcc_stack_fn(False, 1)(*stack))[0]
        got = tpcc.resolve_stack(*map(_t, stack))
        assert [int(x) for x in got] == [int(x) for x in want]
        assert int(got[0]) > 0


@pytest.mark.parametrize("seed", range(2))
def test_window_oracle_matches_plain(seed):
    rng = np.random.default_rng(30 + seed)
    cases = [_random_window(rng, 96, 11, 40), _random_window(rng, 130, 5, 400)]
    cases += [(k, r) for _, r, k in
              tpcc.tpcc_windows(tpcc.tpcc_keys(600, 2, seed), 200)]
    for tk, tr in cases:
        edges, wave = keyset.keyset_windows(_t(tk[None]), _t(tr[None]))
        assert tpcc.window_oracle(tk, tr) == (int(edges[0]), int(wave[0]))


def test_tpcc_windows_match_scalar_loop():
    """The vectorized host preparation == bench.py:1062-1084's loop, copied
    here as the reference, on a stream whose last window is short."""
    n, window = 2600, 512
    keys = tpcc.tpcc_keys(n, 4, 11)
    last_writer, want = {}, []
    for w0 in range(0, n, window):
        kwin = keys[w0:w0 + window]
        kmap = {int(k): i for i, k in enumerate(np.unique(kwin))}
        k = 1024
        while k < len(kmap):
            k *= 2
        prev = np.full(k, -1, np.int32)
        for key, i in kmap.items():
            prev[i] = last_writer.get(key, -1)
        txn_keys = np.full((window, 11), -1, np.int32)
        for b in range(kwin.shape[0]):
            row = sorted({kmap[int(x)] for x in kwin[b]})
            txn_keys[b, :len(row)] = row
        txn_rank = np.full(window, -1, np.int32)
        txn_rank[:kwin.shape[0]] = np.arange(w0, w0 + kwin.shape[0])
        for b in range(kwin.shape[0]):
            for x in kwin[b]:
                last_writer[int(x)] = w0 + b
        want.append((prev, txn_rank, txn_keys))
    got = tpcc.tpcc_windows(keys, window)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_replay_matches_bench_tpcc(monkeypatch):
    """The whole lane at a small size: the same counts as bench_tpcc with
    the same arguments (its emit captured, so no history is written)."""
    rows = []
    monkeypatch.setattr(bench, "emit", rows.append)
    kw = dict(n_txns=3000, warehouses=4, window=256, seed=5)
    bench.bench_tpcc(**kw)
    got = tpcc.replay(**kw, device="cpu")
    keys = ("edges", "edges_cross_window", "edges_in_window",
            "max_wave_depth", "windows", "txns")
    assert {k: got[k] for k in keys} == {k: rows[0][k] for k in keys}
    assert (got["edges"], got["edges_cross_window"], got["edges_in_window"],
            got["max_wave_depth"], got["windows"]) == \
        (13160, 3812, 9348, 13, 12)
    assert got["kernel_path"] == "plain"
    assert got["tpcc_neworder_resolve_ms"] is None


def test_tpcc_main_prints_one_json_line(capsys):
    assert tpcc.main(["--device", "cpu", "--txns", "700", "--window",
                      "128"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    row = json.loads(out[0])
    assert row["windows"] == 6 and row["txns"] == 700
    assert row["edges"] == row["edges_cross_window"] + row["edges_in_window"]
    assert row["txns_per_sec"] is None and row["hardware"] == "cpu"


def test_keyset_windows_cuda_takes_plain_on_cpu():
    """On CPU tensors the wrapper returns the plain version's results and
    launches nothing; tensors on several devices are refused."""
    tk, tr = _pallas_inputs(0)
    cuda_kernels.reset_launch_counts()
    got = cuda_kernels.keyset_windows_cuda(_t(tk), _t(tr))
    want = keyset.keyset_windows(_t(tk), _t(tr))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cuda_kernels.KEYSET_WINDOWS.launches == 0
    with pytest.raises(ValueError, match="counted by the kernel"):
        cuda_kernels.keyset_windows_cuda(
            _t(tk), _t(tr), stats=torch.zeros((3, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="several devices"):
        cuda_kernels.keyset_windows_cuda(_t(tk), _t(tr).to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_kernels.keyset_windows_cuda(_t(tk).to("meta"), _t(tr).to("meta"))
