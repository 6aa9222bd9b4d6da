"""The port's sharded step in its torch.distributed form, on the CPU.

Four spawned processes join a gloo group; rank r computes shard r of the
stacked arguments and the all-reduces combine the counts and the key-sharing
counts.  Their gathered outputs must be == JAX ``make_sharded_step`` (and
``make_sharded_deps_step``) on a 4-device sub-mesh of tests/conftest.py's
virtual CPU devices.  The ranks import this module, so it imports neither
jax nor accord_tpu at its top: the JAX side is imported inside the test.
"""

import sys
import time

import numpy as np
import torch.distributed as dist
import torch.multiprocessing as mp

from accord_tpu_torch import workload
from accord_tpu_torch.ops.encode import window_to_tensors
from accord_tpu_torch.ops.sharded import (ShardedEncoder,
                                          make_sharded_deps_step,
                                          make_sharded_step)
from accord_tpu_torch.utils.random_source import RandomSource as PortRandom

WORLD = 4
SEED = 450
JOIN_TIMEOUT_S = 120


def _rank(rank, world, init_file, args, out_dir):
    """One rank: the sharded step and the deps step on the stacked numpy
    `args`, through a gloo group of `world` ranks; its outputs go to
    out_dir/rank<r>.npz."""
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        t = window_to_tensors(args, device="cpu")
        step = make_sharded_step(world, group=group)(*t)
        deps = make_sharded_deps_step(world, group=group)(*t[:7], t[8])
        np.savez(f"{out_dir}/rank{rank}.npz",
                 *[o.numpy() for o in step + deps],
                 jax_loaded=np.array("jax" in sys.modules
                                     or "accord_tpu" in sys.modules))
    finally:
        dist.destroy_process_group()


def _run_ranks(args, tmp_path):
    ctx = mp.start_processes(
        _rank, args=(WORLD, tmp_path / "rendezvous", args, tmp_path),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"the {WORLD} gloo ranks did not finish "
                                     f"in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]


def test_gloo_sharded_step_matches_jax(tmp_path):
    import jax
    from jax.sharding import Mesh

    from accord_tpu.ops.sharded import ShardedEncoder as JaxShardedEncoder
    from accord_tpu.ops.sharded import (make_sharded_deps_step as jax_deps,
                                        make_sharded_step as jax_step)
    from accord_tpu.utils.random_source import RandomSource as JaxRandom
    from tests.test_ops import random_world as jax_random_world

    kw = dict(n_keys=14, n_existing=120, n_batch=24)
    enc = ShardedEncoder(*workload.random_world(PortRandom(SEED), **kw),
                         WORLD)
    jenc = JaxShardedEncoder(*jax_random_world(JaxRandom(SEED), **kw), WORLD)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("shard",))
    ja = jenc.args()
    want = [np.asarray(w) for w in jax_step(mesh)(*ja)]
    want_deps = [np.asarray(w) for w in
                 jax_deps(mesh)(*ja[:5], ja[5], ja[6], ja[8])]

    outs = _run_ranks(enc.args(), tmp_path)
    assert not any(bool(o["jax_loaded"]) for o in outs)
    # rank r returns its own plane; the rest is the same on every rank
    for i, w in ((0, want[0]), (4, want_deps[0])):
        got = np.concatenate([o[f"arr_{i}"] for o in outs])
        assert got.dtype == w.dtype and np.array_equal(got, w)
    for o in outs:
        for i, w in ((1, want[1]), (2, want[2]), (3, want[3]),
                     (5, want_deps[1])):
            assert o[f"arr_{i}"].dtype == w.dtype
            assert np.array_equal(o[f"arr_{i}"], w)
    assert int(want[1].sum()) > 0 and int(want[3].max()) > 0
    # and the stacked step on one device gives the same
    stacked = make_sharded_step(WORLD)(*window_to_tensors(enc.args(),
                                                          device="cpu"))
    for g, w in zip(stacked, want):
        assert np.array_equal(g.numpy(), w)
