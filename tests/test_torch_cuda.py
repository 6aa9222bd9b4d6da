"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an sm_90 CUDA card (the kernels have no CPU mode) and skip
elsewhere.  The file imports neither jax nor accord_tpu, so on a machine
without JAX it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Every output is integer or boolean: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from accord_tpu_torch.entry import entry
from accord_tpu_torch.ops import (cuda_kernels, deps_kernel, keyset,
                                  range_kernel, wavefront)
from accord_tpu_torch.ops.encode import BatchEncoder, window_to_tensors
from accord_tpu_torch.ops.recovery_kernel import (RecoveryEncoder,
                                                  batched_recovery_scans,
                                                  scalar_predicates)
from accord_tpu_torch.ops.sharded import ShardedEncoder, make_sharded_step
from accord_tpu_torch.tpcc import window_oracle
from accord_tpu_torch.utils.random_source import RandomSource
from accord_tpu_torch.workload import (build_world, keyset_cases,
                                       large_keyset_window, random_world,
                                       range_cases, range_index_cases,
                                       recovery_world)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_deps_tile_kernel_matches_plain(card):
    worlds = [random_world(RandomSource(800 + s), n_keys=30, n_existing=300,
                           n_batch=150) for s in range(3)]
    worlds.append(build_world(n_keys=16500, n_existing=500, n_batch=130,
                              seed=5))
    for cfks, batch in worlds:
        enc = BatchEncoder(cfks, batch)
        er, eer, ek, es, ekd, tr, twm, _, touches = window_to_tensors(
            enc.state, enc.dbatch, card)
        succ = deps_kernel.successor_write_eat(er, eer, ek, es, ekd)
        args = (touches, ek, er, eer, es, ekd, succ, tr, twm)
        before = cuda_kernels.DEPS_TILE.launches
        mask, count = cuda_kernels.deps_tile_cuda(*args)
        assert cuda_kernels.DEPS_TILE.launches == before + 1
        want_mask, want_count = deps_kernel.deps_tile(*args)
        assert torch.equal(mask, want_mask)
        assert torch.equal(count, want_count)


@pytest.mark.parametrize("cut_e,cut_b", [(3, 0), (8, 5), (13, 31)])
def test_deps_tile_kernel_ragged_matches_plain(card, cut_e, cut_b):
    """E not a multiple of 16 (rows not 16-byte aligned: the byte-wise
    stores) and B not a multiple of 32 (a partial row group)."""
    cfks, batch = random_world(RandomSource(820 + cut_e), n_keys=30,
                               n_existing=300, n_batch=150)
    enc = BatchEncoder(cfks, batch)
    er, eer, ek, es, ekd, tr, twm, _, touches = window_to_tensors(
        enc.state, enc.dbatch, card)
    succ = deps_kernel.successor_write_eat(er, eer, ek, es, ekd)
    e, b = er.shape[0] - cut_e, tr.shape[0] - cut_b
    assert e % 16 != 0
    args = (touches[:b].contiguous(),) + tuple(
        a[:e].contiguous() for a in (ek, er, eer, es, ekd, succ)) \
        + (tr[:b].contiguous(), twm[:b].contiguous())
    mask, count = cuda_kernels.deps_tile_cuda(*args)
    want_mask, want_count = deps_kernel.deps_tile(*args)
    assert torch.equal(mask, want_mask)
    assert torch.equal(count, want_count)
    assert int(count.sum()) > 0


def _sharded_world(n_shards):
    """S = 1 over 30 keys; S = 2 over 16,500 keys (K = 16,500, above the
    Pallas tile's 16,384); S = 8 over 5 keys (three shards hold no key and
    no entry: all pads)."""
    if n_shards == 2:
        return build_world(n_keys=16500, n_existing=500, n_batch=130, seed=5)
    n_keys = 30 if n_shards == 1 else 5
    return random_world(RandomSource(840 + n_shards), n_keys=n_keys,
                        n_existing=300, n_batch=150)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_deps_tile_kernel_stacked_matches_plain(card, n_shards):
    """K1 over S shards in one launch pair == its per-shard plain loop, with
    E as encoded (a multiple of 8) and cut by 8 (so one of the two is 8 mod
    16: every other row of a plane starts off a 16-byte boundary) and by 3
    (the byte-wise rows); then the sharded step launches K1 once and K2 once
    whatever S, == the step on the CPU."""
    cfks, batch = _sharded_world(n_shards)
    enc = ShardedEncoder(cfks, batch, n_shards)
    args = window_to_tensors(enc.args(), device=card)
    er, eer, ek, es, ekd, tr, twm, _, touches = args
    succ = deps_kernel.sharded_successor_write_eat(er, eer, ek, es, ekd,
                                                   enc.ks)
    e = er.shape[1]
    assert {(e - cut) % 16 for cut in (0, 8)} == {0, 8}
    for cut in (0, 8, 3):
        entries = tuple(a[:, :e - cut].contiguous()
                        for a in (ek, er, eer, es, ekd, succ))
        k1_args = (touches,) + entries + (tr, twm)
        before = cuda_kernels.DEPS_TILE.launches
        mask, count = cuda_kernels.deps_tile_cuda(*k1_args)
        assert cuda_kernels.DEPS_TILE.launches == before + 1
        want_mask, want_count = deps_kernel.sharded_deps_tile(*k1_args)
        assert mask.shape == (n_shards, tr.shape[0], e - cut)
        assert torch.equal(mask, want_mask), cut
        assert torch.equal(count, want_count), cut
    assert int(count.sum()) > 0
    if n_shards == 8:
        assert not er[5:].ge(0).any()             # the empty shards
    cuda_kernels.reset_launch_counts()
    got = make_sharded_step(n_shards)(*args)
    assert [k.launches for k in cuda_kernels.KERNELS] == [1, 1, 0, 0]
    for g, w in zip(got, make_sharded_step(n_shards)(
            *(a.cpu() for a in args))):
        assert torch.equal(g.cpu(), w)


def _random_dag(rng, n, p):
    rank = rng.permutation(n).astype(np.int32)
    return (rng.random((n, n)) < p) & (rank[None, :] < rank[:, None]), rank


def _wave_case(name):
    """-> (dep [B, B] bool, txn_rank [B] int32 or None, the path K2 must
    take: 1 forward, 0 fixpoint, and whether it sorts the ranks)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "triangular with txn_rank":
        n = 512
        rank = np.arange(n, dtype=np.int32)
        rank[rng.random(n) < 0.2] += 1            # ties, still ascending
        dep = (rng.random((n, n)) < 0.08) & (rank[None, :] < rank[:, None])
        return dep, rank, 1, 0
    if name == "permuted ranks":
        dep, rank = _random_dag(rng, 512, 0.08)
        rank[rng.random(512) < 0.1] = -1          # padded rows, no edges
        dep &= (rank >= 0)[None, :] & (rank >= 0)[:, None]
        return dep, rank, 1, 1
    if name == "permuted rows without txn_rank":
        dep, _ = _random_dag(rng, 512, 0.08)
        return dep, None, 0, 0
    if name == "cycle":
        dep, rank = _random_dag(rng, 300, 0.05)
        dep[np.argmin(rank), np.argmax(rank)] = True  # closes many cycles
        return dep, rank, 0, 1
    if name == "B = 1":
        return np.zeros((1, 1), bool), np.zeros(1, np.int32), 1, 0
    if name == "B = 1, self loop":
        return np.ones((1, 1), bool), np.zeros(1, np.int32), 0, 0
    if name == "B = 2048":
        dep, rank = _random_dag(rng, 2048, 0.01)
        return dep, rank, 1, 1
    if name == "B = 1001 chain":
        n = 1001
        dep = np.zeros((n, n), bool)
        dep[np.arange(1, n), np.arange(n - 1)] = True
        return dep, np.arange(n, dtype=np.int32), 1, 0
    assert name == "empty DAG"
    return np.zeros((700, 700), bool), None, 1, 0


@pytest.mark.parametrize("name", [
    "triangular with txn_rank", "permuted ranks",
    "permuted rows without txn_rank", "cycle", "B = 1", "B = 1, self loop",
    "B = 2048", "B = 1001 chain", "empty DAG"])
def test_wavefront_kernel_paths(card, name):
    """K2 == plain on both of its paths, and takes the path the input calls
    for: the forward pass when the rows in rank order make the matrix
    strictly lower triangular, the fixpoint otherwise (cycles keep -1)."""
    dep_np, rank_np, forward, sorted_ranks = _wave_case(name)
    dep = torch.from_numpy(dep_np).to(card)
    rank = None if rank_np is None else torch.from_numpy(rank_np).to(card)
    stats = torch.zeros(3, dtype=torch.int32, device=card)
    got = cuda_kernels.execution_waves_cuda(dep, rank, stats=stats)
    want = wavefront.execution_waves(dep)
    assert torch.equal(got, want)
    assert stats.tolist()[:2] == [forward, sorted_ranks]
    if name == "cycle":
        assert int((got == -1).sum()) > 0


@pytest.mark.parametrize("n,p", [(512, 0.08), (1152, 0.02), (2048, 0.01)])
def test_wavefront_kernel_matches_plain(card, n, p):
    """Random DAGs, and chains as deep as the window, on both sides of the
    shared-memory limit of the packed matrix."""
    rng = np.random.default_rng(n)
    rank = rng.permutation(n)
    chain = np.zeros((n, n), bool)
    chain[np.arange(1, n), np.arange(n - 1)] = True
    for dep in ((rng.random((n, n)) < p) & (rank[None, :] < rank[:, None]),
                chain):
        dep_t = torch.from_numpy(dep).to(card)
        got = cuda_kernels.execution_waves_cuda(dep_t)
        assert torch.equal(got, wavefront.execution_waves(dep_t))
    assert int(got.max()) == n - 1


def test_resolve_step_on_card_matches_cpu(card):
    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    cuda_kernels.reset_launch_counts()
    got = fn(*args)
    assert [k.launches for k in cuda_kernels.KERNELS] == [1, 1, 0, 0]
    for g, w in zip(got, fn(*(a.cpu() for a in args))):
        assert torch.equal(g.cpu(), w)


def _keyset_case(rng, w, b, p, domain):
    tk = np.where(rng.random((w, b, p)) < 0.9,
                  rng.integers(0, domain, (w, b, p)), -1).astype(np.int32)
    tr = np.tile(np.arange(b, dtype=np.int32), (w, 1))
    tr[min(1, w - 1), -7:] = -1                       # padded tail rows
    return tk, tr


@pytest.mark.parametrize("w,b,domain", [(3, 128, 60), (1, 2048, 300)])
def test_keyset_windows_kernel_matches_plain(card, w, b, domain):
    """K4 == its plain version on the tests/test_pallas.py inputs and on one
    B = 2048 window over 300 keys (runs of ~67 rows, a DAG 784 waves deep),
    one launch per call."""
    tk, tr = _keyset_case(np.random.default_rng(b), w, b, 11, domain)
    tk, tr = torch.from_numpy(tk).to(card), torch.from_numpy(tr).to(card)
    want = keyset.keyset_windows(tk, tr)
    before = cuda_kernels.KEYSET_WINDOWS.launches
    got = cuda_kernels.keyset_windows_cuda(tk, tr)
    assert cuda_kernels.KEYSET_WINDOWS.launches == before + 1
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert int(want[1].max()) > 0


@pytest.mark.parametrize("case", range(10))
def test_keyset_windows_kernel_edge_cases(card, case):
    """K4 == plain == window_oracle on workload.keyset_cases: tied ranks,
    keys at 0 and 2**31-1, all rows padded, one key in every row, P = 1,
    P = 5, 22,528 key slots at B = 2048, P = 11 and B = 1408, P = 16, and
    the large-window kernel's B = 4096, P = 11 and B = 1200, P = 20."""
    label, tk_np, tr_np = keyset_cases(full_slots=True)[case]
    tk, tr = torch.from_numpy(tk_np).to(card), torch.from_numpy(tr_np).to(card)
    stats = torch.zeros((1, 3), dtype=torch.int32, device=card)
    got = cuda_kernels.keyset_windows_cuda(tk, tr, stats=stats)
    want = keyset.keyset_windows(tk, tr)
    for g, x in zip(got, want):
        assert torch.equal(g, x), label
    assert window_oracle(tk_np[0], tr_np[0]) == (int(got[0][0]),
                                                 int(got[1][0])), label
    assert int(stats[0, 2]) >= 1


def test_keyset_windows_kernel_range(card):
    """Every P >= 1 and B*P up to 2^22 launch, in the shared-memory kernel up
    to P = 16 and 22,528 key slots and in the large-window kernel above;
    outside, the wrapper raises with the reason and launches nothing."""
    for b, p, in_smem in ((22_528, 1, True), (1, 16, True), (1408, 16, True),
                          (4, 17, False), (22_529, 1, False),
                          (1409, 16, False), (2, 2 ** 21, False)):
        assert cuda_kernels.keyset_windows_in_smem(b, p) == in_smem
        tk = torch.full((1, b, p), 5, dtype=torch.int32, device=card)
        tr = torch.arange(b, dtype=torch.int32, device=card)[None]
        edges, wave = cuda_kernels.keyset_windows_cuda(tk, tr)
        assert int(edges[0]) == b * (b - 1) // 2 and int(wave[0]) == b - 1
    before = cuda_kernels.KEYSET_WINDOWS.launches
    for b, p in ((2 ** 22 + 1, 1), (2, 2 ** 21 + 1), (4, 0)):
        tk = torch.zeros((1, b, p), dtype=torch.int32, device=card)
        tr = torch.zeros((1, b), dtype=torch.int32, device=card)
        with pytest.raises(ValueError, match="key slots a window"):
            cuda_kernels.keyset_windows_cuda(tk, tr)
    assert cuda_kernels.KEYSET_WINDOWS.launches == before


@pytest.mark.parametrize("b,p", [(4096, 11), (1200, 20)])
def test_keyset_windows_large_windows(card, b, p):
    """Windows above the shared-memory range launch K4's large-window
    kernel, W = 3 at a time, == plain == window_oracle."""
    windows = [large_keyset_window(b, p, seed=s) for s in range(3)]
    tk_np = np.concatenate([w[1] for w in windows])
    tr_np = np.concatenate([w[2] for w in windows])
    tk, tr = torch.from_numpy(tk_np).to(card), torch.from_numpy(tr_np).to(card)
    before = cuda_kernels.KEYSET_WINDOWS.launches
    got = cuda_kernels.keyset_windows_cuda(tk, tr)
    assert cuda_kernels.KEYSET_WINDOWS.launches == before + 1
    assert not cuda_kernels.keyset_windows_in_smem(b, p)
    want = keyset.keyset_windows(tk, tr)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    for wi in range(3):
        assert window_oracle(tk_np[wi], tr_np[wi]) == (int(got[0][wi]),
                                                       int(got[1][wi]))


@pytest.mark.parametrize("case", range(6))
def test_range_stab_kernel_matches_plain(card, case):
    """K5 == plain on workload.range_cases: N and Q no multiple of any tile,
    N = 1 and Q = 1, bounds at -2**31 and 2**31-1, touching bounds, [0, 0)
    pads against negative queries; one launch a call."""
    label, *arrays = range_cases()[case]
    s, e, qs, qe = (torch.from_numpy(a).to(card) for a in arrays)
    before = cuda_kernels.RANGE_STAB.launches
    got = cuda_kernels.range_stab_counts_cuda(s, e, qs, qe)
    assert cuda_kernels.RANGE_STAB.launches == before + 1
    assert torch.equal(got, range_kernel.range_stab_counts(s, e, qs, qe)), \
        label


@pytest.mark.parametrize("case", range(10))
def test_range_stab_kernel_index_cases(card, case):
    """K5 == the dense plain version == stab_counts_by_query_index on
    workload.range_index_cases: inverted intervals and queries, [0, 0)
    pads against [0, 0) queries, tied bounds, one hot bin, three query
    tiles, N = 0, Q = 1, N = 1; one launch a call."""
    label, *arrays = range_index_cases()[case]
    s, e, qs, qe = (torch.from_numpy(a).to(card) for a in arrays)
    before = cuda_kernels.RANGE_STAB.launches
    got = cuda_kernels.range_stab_counts_cuda(s, e, qs, qe)
    assert cuda_kernels.RANGE_STAB.launches == before + 1
    assert torch.equal(got, range_kernel.range_stab_counts(s, e, qs, qe)), \
        label
    assert torch.equal(got, range_kernel.stab_counts_by_query_index(
        s, e, qs, qe)), label


def test_range_stab_phases_time_each_launch(card):
    """range_stab_phases gives a positive CUDA-event time for each of K5's
    four launches, and the buffers it timed on still count right."""
    _, *arrays = range_index_cases()[6]   # inverted and empty bounds
    args = [torch.from_numpy(a).to(card) for a in arrays]
    times = cuda_kernels.range_stab_phases(*args, reps=3, per_batch=2)
    assert list(times) == list(cuda_kernels.RANGE_STAB_PHASES)
    assert all(t > 0 for t in times.values()), times
    assert torch.equal(cuda_kernels.range_stab_counts_cuda(*args),
                       range_kernel.range_stab_counts(*args))


def test_recovery_scans_on_card_match_cpu(card):
    """batched_recovery_scans on CUDA tensors == on CPU tensors, and folded
    and decoded == the scalar scans, probe by probe."""
    cfks, probes = recovery_world(n_keys=64, n_existing=1500, n_probes=128,
                                  seed=4)
    enc = RecoveryEncoder(cfks, probes)
    got = batched_recovery_scans(*enc.tensors(card))
    want = batched_recovery_scans(*enc.tensors("cpu"))
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
    got = [g.cpu().numpy() for g in got]
    for i, (probe, keys) in enumerate(probes):
        ra, rb, cw, anw = scalar_predicates(cfks, probe, keys)
        assert (bool(got[0][i].any()), bool(got[1][i].any())) == (ra, rb)
        assert enc.decode_ids(got[2][i]) == cw
        assert enc.decode_ids(got[3][i]) == anw


@pytest.mark.parametrize("mesh", [False, True])
def test_store_on_card_matches_cpu(card, mesh):
    """A small seeded plan through the port's store on the card and on the
    CPU, verify on: every op's result and every device_* counter after each
    window equal, the final state equal; the card's store launched K1 (or
    stacked K1) and K2."""
    from accord_tpu_torch.impl.device_store import (DeviceCommandStore,
                                                    MeshDeviceCommandStore)
    from accord_tpu_torch.workload import (StoreNode, StorePlanRunner,
                                           device_counters, store_plan,
                                           store_state)

    mix = (("preaccept", 0.40), ("accept", 0.05), ("commit", 0.20),
           ("apply", 0.25), ("recover", 0.05), ("range", 0.05))
    plan = store_plan(21, n_txns=300, window=(16, 64), mix=mix)
    cls = MeshDeviceCommandStore if mesh else DeviceCommandStore
    extra = {"n_shards": 8} if mesh else {}
    runners = []
    for device in (card, "cpu"):
        node = StoreNode()
        store = cls.factory(verify=True, device=device, **extra)(
            0, node, node.kit.Ranges.of((0, 1 << 20)))
        runners.append(StorePlanRunner(store, node, plan))
    gpu, cpu = runners
    before = {k.name: k.launches for k in cuda_kernels.KERNELS}
    for w, ops in enumerate(plan[1]):
        assert gpu.run_window(ops) == cpu.run_window(ops), f"window {w}"
        assert device_counters(gpu.store) == device_counters(cpu.store), \
            f"window {w}"
    assert store_state(gpu.store) == store_state(cpu.store)
    launched = {k.name: k.launches - before[k.name]
                for k in cuda_kernels.KERNELS}
    # one K1 launch a deps batch; device_batches also counts the recovery
    # batches, which run plain torch
    assert 0 < launched["deps_tile"] <= gpu.store.device_batches
    assert launched["wavefront"] == gpu.store.device_wave_batches > 0
    assert not gpu.store.device_disabled
