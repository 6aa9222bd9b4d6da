"""The port's sharded resolve step against the JAX package, on the CPU.

``accord_tpu_torch.ops.sharded`` (ShardedEncoder, make_sharded_step,
make_sharded_deps_step) must give the JAX module's arrays and outputs
exactly on the same worlds: the encoder's nine arrays, dtype and shape
included, and the step's four outputs against ``make_sharded_step`` on the
8-device virtual CPU mesh of tests/conftest.py, element for element.  Every
output is integer or boolean, so the tolerance throughout is ==.  The
form over a list of devices runs here on CPU "devices", its all-reduce in
its plain version; the torch.distributed form is held == in
tests/test_torch_sharded_gloo.py.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from accord_tpu.ops import make_sharded_step as jax_make_sharded_step
from accord_tpu.ops.sharded import ShardedEncoder as JaxShardedEncoder
from accord_tpu.ops.sharded import \
    make_sharded_deps_step as jax_make_sharded_deps_step
from accord_tpu.utils.random_source import RandomSource as JaxRandom
from accord_tpu_torch import entry as port_entry
from accord_tpu_torch import workload
from accord_tpu_torch.ops import cuda_kernels, deps_kernel
from accord_tpu_torch.ops.encode import (PAD, scalar_deps_oracle,
                                         window_to_tensors)
from accord_tpu_torch.ops.sharded import (ShardedEncoder, dep_mask_to_host,
                                          make_sharded_deps_step,
                                          make_sharded_step, resolve_step,
                                          shard_to_devices)
from accord_tpu_torch.utils import backend
from accord_tpu_torch.utils.random_source import RandomSource as PortRandom
from tests.test_ops import random_world as jax_random_world

ARRAYS = ("entry_rank", "entry_eat_rank", "entry_key", "entry_status",
          "entry_kind", "txn_rank", "txn_witness_mask", "txn_kind", "touches")


def _ids(ts_list):
    return [(t.epoch, t.hlc, t.flags, t.node) for t in ts_list]


def _worlds(seed, **kw):
    """The same random world built by each package from one seed."""
    return (jax_random_world(JaxRandom(seed), **kw),
            workload.random_world(PortRandom(seed), **kw))


def _probes(batch):
    """Deps probes as the device store collects them: (before, witnessed
    kinds, keys)."""
    return [(tid, tid.kind.witnesses(), keys) for tid, keys in batch]


def _mesh(n):
    devices = np.array(jax.devices()[:n])
    assert devices.size == n, "conftest must force 8 virtual CPU devices"
    return Mesh(devices, ("shard",))


def _assert_same_arrays(port_enc, jax_enc):
    for name, p, j in zip(ARRAYS, port_enc.args(), jax_enc.args()):
        assert p.dtype == j.dtype and p.shape == j.shape, name
        assert np.array_equal(p, j), name
    assert port_enc.ks == jax_enc.ks
    assert [[k.token for k in b] for b in port_enc.blocks] == \
        [[k.token for k in b] for b in jax_enc.blocks]
    assert [[(li, _ids([t])[0], st) for li, t, st, _ in es]
            for es in port_enc.entries_per] == \
        [[(li, _ids([t])[0], st) for li, t, st, _ in es]
         for es in jax_enc.entries_per]


@pytest.mark.parametrize("seed,n_shards,n_keys",
                         [(400, 8, 16), (401, 3, 13), (402, 8, 5),
                          (403, 1, 12)])
def test_sharded_encoder_matches_jax(seed, n_shards, n_keys):
    """Both constructors give the JAX encoder's nine arrays, key blocks and
    entries: 8 shards of 2 keys, 3 uneven shards, 8 shards over 5 keys
    (three shards hold no key at all) and one shard."""
    (jc, jb), (pc, pb) = _worlds(seed, n_keys=n_keys, n_existing=80,
                                 n_batch=16)
    _assert_same_arrays(ShardedEncoder(pc, pb, n_shards),
                        JaxShardedEncoder(jc, jb, n_shards))
    port = ShardedEncoder.for_probes(pc, _probes(pb), n_shards, pad=PAD)
    _assert_same_arrays(port, JaxShardedEncoder.for_probes(
        jc, _probes(jb), n_shards, pad=PAD))
    if n_keys < n_shards:
        assert sum(not b for b in port.blocks) == n_shards - n_keys
        assert not port.touches[:, n_keys * port.ks:].any()


@pytest.mark.parametrize("seed", range(4))
def test_sharded_step_matches_jax(seed):
    """The stacked step's four outputs == JAX make_sharded_step's on the
    8-device mesh (tests/test_ops.py:134's worlds), the deps == the scalar
    oracle, and on CPU tensors no kernel launch is counted."""
    (jc, jb), (pc, pb) = _worlds(400 + seed, n_keys=16, n_existing=80,
                                 n_batch=16)
    jenc = JaxShardedEncoder(jc, jb, n_shards=8)
    want = jax_make_sharded_step(_mesh(8))(*jenc.args())
    enc = ShardedEncoder(pc, pb, 8)
    before = [k.launches for k in cuda_kernels.KERNELS]
    got = make_sharded_step(8)(*window_to_tensors(enc.args(), device="cpu"))
    assert [k.launches for k in cuda_kernels.KERNELS] == before
    for name, g, w in zip(("dep_mask", "dep_count", "dep_bb", "waves"),
                          got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g.numpy(), w), name
    assert [_ids(r) for r in enc.decode_deps(got[0].numpy())] == \
        [_ids(r) for r in scalar_deps_oracle(pc, pb)]


@pytest.mark.parametrize("seed,pad", [(410, 8), (411, PAD)])
def test_sharded_deps_step_and_key_deps_match_jax(seed, pad):
    """The deps step on probes (without txn_kind, as the device store calls
    it) == JAX make_sharded_deps_step, and decode_key_deps == the JAX
    encoder's, key for key."""
    (jc, jb), (pc, pb) = _worlds(seed, n_keys=16, n_existing=120,
                                 n_batch=24)
    jenc = JaxShardedEncoder.for_probes(jc, _probes(jb), 8, pad=pad)
    ja = jenc.args()
    j_mask, j_count = jax_make_sharded_deps_step(_mesh(8))(
        *ja[:5], ja[5], ja[6], ja[8])
    enc = ShardedEncoder.for_probes(pc, _probes(pb), 8, pad=pad)
    a = window_to_tensors(enc.args(), device="cpu")
    mask, count = make_sharded_deps_step(8)(*a[:7], a[8])
    assert np.array_equal(mask.numpy(), np.asarray(j_mask))
    assert np.array_equal(count.numpy(), np.asarray(j_count))

    def flat(keyed):
        return [{k.token: _ids(v) for k, v in m.items()} for m in keyed]

    got = flat(enc.decode_key_deps(mask.numpy()))
    assert got == flat(jenc.decode_key_deps(np.asarray(j_mask)))
    assert sum(len(v) for m in got for v in m.values()) > 0


@pytest.mark.parametrize("seed", range(2))
def test_one_shard_is_resolve_step(seed):
    """S = 1: the sharded step's outputs are exactly resolve_step's on the
    same arrays (the stack's one plane)."""
    _, (pc, pb) = _worlds(420 + seed, n_keys=12, n_existing=80, n_batch=16)
    args = window_to_tensors(ShardedEncoder(pc, pb, 1).args(), device="cpu")
    got = make_sharded_step(1)(*args)
    want = resolve_step(*(a[0] for a in args[:5]), *args[5:])
    assert got[0].shape[0] == 1 and torch.equal(got[0][0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


def test_shards_sharing_local_keys_keep_their_own_successors():
    """Local key 0 of every shard holds committed writes, so merging the
    shards' keys into one segment would change succ_w (checked here): the
    one-pass succ_w over the stack == each shard's alone, and the step ==
    JAX's, which computes each shard on its own device."""
    (jc, jb), (pc, pb) = _worlds(430, n_keys=16, n_existing=200, n_batch=16)
    enc = ShardedEncoder(pc, pb, 8)
    er, eer, ek, es, ekd = window_to_tensors(enc.args(), device="cpu")[:5]
    stacked = deps_kernel.sharded_successor_write_eat(er, eer, ek, es, ekd,
                                                      enc.ks)
    per_shard = torch.stack([deps_kernel.successor_write_eat(
        er[s], eer[s], ek[s], es[s], ekd[s]) for s in range(8)])
    merged = deps_kernel.successor_write_eat(
        *(a.reshape(-1) for a in (er, eer, ek, es, ekd))).reshape(er.shape)
    assert torch.equal(stacked, per_shard)
    assert not torch.equal(merged, per_shard)
    want = jax_make_sharded_step(_mesh(8))(
        *JaxShardedEncoder(jc, jb, 8).args())
    got = make_sharded_step(8)(*window_to_tensors(enc.args(), device="cpu"))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_dryrun_multichip_on_cpu():
    """The dry run's sharded-step leg (its protocol leg, a burn of ~30 s
    here, runs in the slow test below)."""
    out = port_entry.dryrun_sharded_step(8, device="cpu")
    assert out["n_shards"] == 8 and out["device"] == "cpu"
    assert out["edges"] > 0 and out["max_wave"] >= 0


@pytest.mark.slow
def test_dryrun_multichip_protocol_leg_on_cpu():
    """Both legs of the dry run, as the JAX ``dryrun_multichip`` runs them:
    after the sharded step, the hostile verify=True burn served by the mesh
    store at S = 8, with no op lost or pending, acks and device hits."""
    out = port_entry.dryrun_multichip(8, device="cpu")
    assert out["n_shards"] == 8 and out["edges"] > 0
    assert out["protocol_acks"] > 0 and out["protocol_device_hits"] > 0


def test_sharded_step_rejects_what_the_layout_forbids():
    """Entry arrays of another shard count, or touches whose columns do not
    split into key blocks, raise before any work."""
    _, (pc, pb) = _worlds(440, n_keys=16, n_existing=40, n_batch=8)
    args = window_to_tensors(ShardedEncoder(pc, pb, 4).args(), device="cpu")
    with pytest.raises(ValueError, match="for 8 shards"):
        make_sharded_step(8)(*args)
    with pytest.raises(ValueError, match="key blocks"):
        make_sharded_deps_step(4)(*args[:7], args[8][:, 1:])


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_steps_over_devices_match_jax(n_devices):
    """8 shards over 1, 2, 4 and 8 CPU devices, blocks of 8/D shards a
    device: both steps == JAX make_sharded_step and make_sharded_deps_step
    on the 8-device mesh, the planes one a device in shard order, the
    counts summed by the all-reduce's plain version; no kernel launch."""
    (jc, jb), (pc, pb) = _worlds(460 + n_devices, n_keys=16, n_existing=120,
                                 n_batch=24)
    ja = JaxShardedEncoder(jc, jb, n_shards=8).args()
    want = jax_make_sharded_step(_mesh(8))(*ja)
    want_deps = jax_make_sharded_deps_step(_mesh(8))(*ja[:7], ja[8])
    args = ShardedEncoder(pc, pb, 8).args()
    devices = ["cpu"] * n_devices
    placed = shard_to_devices(args, 8, devices)
    assert [a[0].shape[0] for a in placed] == [8 // n_devices] * n_devices
    before = [k.launches for k in cuda_kernels.KERNELS]
    got = make_sharded_step(8, devices=devices)(*args)
    deps = make_sharded_deps_step(8, devices=devices)(*args[:7], args[8])
    assert [k.launches for k in cuda_kernels.KERNELS] == before
    assert len(got[0]) == len(deps[0]) == n_devices
    for name, g, w in (("dep_mask", dep_mask_to_host(got[0]), want[0]),
                       ("dep_count", got[1].numpy(), want[1]),
                       ("dep_bb", got[2].numpy(), want[2]),
                       ("waves", got[3].numpy(), want[3]),
                       ("deps mask", dep_mask_to_host(deps[0]), want_deps[0]),
                       ("deps count", deps[1].numpy(), want_deps[1])):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    assert int(got[1].sum()) > 0


def _fake_cards(monkeypatch, n, capability=(9, 0)):
    """torch.cuda as a host with `n` cards of `capability` would show it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: capability)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "a card")


@pytest.mark.parametrize("case", ["cards", "split", "group"])
def test_devices_form_refuses(monkeypatch, case):
    """No fallback: a card named twice, a missing card, a card that is not
    sm_90, an empty list or cards mixed with the CPU; shards that do not
    split evenly over the devices; a group given with devices.  Each
    raises before any work."""
    if case == "cards":
        _fake_cards(monkeypatch, 4)
        assert backend.resolve_devices("all") == [
            torch.device("cuda", i) for i in range(4)]
        for bad, match in ((["cuda:1", "cuda:1"], "named twice"),
                           (["cuda:0", "cuda:4"], "no card"),
                           ([], "empty"), (["cuda:0", "cpu"], "mixed")):
            with pytest.raises((ValueError, RuntimeError), match=match):
                backend.resolve_devices(bad)
        _fake_cards(monkeypatch, 4, capability=(8, 0))
        with pytest.raises(RuntimeError, match="sm_90a"):
            make_sharded_step(8, devices=["cuda:0", "cuda:1"])
        assert backend.resolve_devices(["cpu"] * 3) == \
            [torch.device("cpu")] * 3
    elif case == "split":
        _, (pc, pb) = _worlds(470, n_keys=16, n_existing=40, n_batch=8)
        args = ShardedEncoder(pc, pb, 8).args()
        for step in (make_sharded_step, make_sharded_deps_step):
            with pytest.raises(ValueError, match="do not split evenly"):
                step(8, devices=["cpu"] * 3)
        with pytest.raises(ValueError, match="do not split evenly"):
            shard_to_devices(args, 8, ["cpu"] * 3)
    else:
        for step in (make_sharded_step, make_sharded_deps_step):
            with pytest.raises(ValueError, match="not both"):
                step(4, group=object(), devices=["cpu"] * 4)


@pytest.mark.slow
def test_dryrun_multichip_over_devices_on_cpu():
    """Both legs of the dry run over 4 CPU devices: the step's checks, and
    a protocol leg whose every store spans the 4 devices."""
    out = port_entry.dryrun_multichip(8, "cpu", devices=["cpu"] * 4)
    assert out["devices"] == ["cpu"] * 4 and out["edges"] > 0
    assert out["protocol_acks"] > 0 and out["protocol_device_hits"] > 0


@pytest.mark.slow
def test_mesh_arm_over_cards_matches_jax_line(capsys):
    """The mesh protocol cell through the burn CLI with --cards 4 on CPU
    devices prints the JAX package's line: where the shards lie does not
    change what the stores serve."""
    from accord_tpu_torch.sim import burn
    argv, want = workload.PROTOCOL_BURNS["mesh"]
    assert burn.main(argv.split() + ["--cards", "4", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == want
