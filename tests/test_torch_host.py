"""The port's real-socket host (``host/tcp.py``) with its device stores.

``_env_store_factory`` is the one place the host differs from the JAX
package's: ``ACCORD_TCP_DEVICE_STORE=1`` puts the port's
``DeviceCommandStore`` behind every node, on ``ACCORD_TCP_DEVICE`` (unset:
the card, which it refuses to replace with the CPU).  The ``slow`` cases
are the JAX package's own slow TCP tests (``tests/test_tcp_host.py``) on
the port with the stores on the CPU, and the multi-process forms: the
``tcp`` bench lane (three node processes) and the Maelstrom runner's three
node processes.  Only the ``slow`` cases open sockets or start processes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from accord_tpu_torch.host import tcp
from accord_tpu_torch.impl.device_store import DeviceCommandStore
from accord_tpu_torch.primitives.keys import Ranges
from accord_tpu_torch.workload import StoreNode, tcp_cluster_txns

REPO = Path(__file__).resolve().parent.parent
TCP_ENV = ("ACCORD_TCP_DEVICE_STORE", "ACCORD_TCP_DEVICE_VERIFY",
           "ACCORD_TCP_FLUSH_US", "ACCORD_TCP_DEVICE")


def test_env_store_factory(monkeypatch):
    """Unset: no factory (the scalar stores).  Asked for on ``cpu``: the
    port's DeviceCommandStore there, with the window and verify flag of the
    environment.  Asked for without a device and without a card: it raises
    rather than pin the CPU."""
    for k in TCP_ENV:
        monkeypatch.delenv(k, raising=False)
    assert tcp._env_store_factory() is None
    monkeypatch.setenv("ACCORD_TCP_DEVICE_STORE", "1")
    monkeypatch.setenv("ACCORD_TCP_DEVICE_VERIFY", "1")
    monkeypatch.setenv("ACCORD_TCP_FLUSH_US", "700")
    monkeypatch.setenv("ACCORD_TCP_DEVICE", "cpu")
    store = tcp._env_store_factory()(0, StoreNode(), Ranges.of((0, 64)))
    assert type(store) is DeviceCommandStore
    assert store.device == torch.device("cpu")
    assert store.verify and store.flush_window_us == 700
    monkeypatch.delenv("ACCORD_TCP_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcp._env_store_factory()


@pytest.mark.slow
def test_three_node_tcp_cluster_strict_serializable(monkeypatch):
    """``tests/test_tcp_host.py``'s three in-process TcpHost nodes with the
    scalar stores: 30 appends, strictly serializable."""
    for k in TCP_ENV:
        monkeypatch.delenv(k, raising=False)
    out = tcp_cluster_txns(n_txns=30, tokens=(10, 11, 12, 13))
    assert not any(isinstance(s, DeviceCommandStore) for s in out["stores"])


@pytest.mark.slow
def test_tcp_cluster_with_device_stores(monkeypatch, capsys):
    """The same cluster with every command store a DeviceCommandStore on
    the CPU, verify on, 500 µs windows and the reference's 20 appends over
    3 keys: strictly serializable, scans device-served, no store off its
    device tier and no exception reported by a node's agent."""
    monkeypatch.setenv("ACCORD_TCP_DEVICE_STORE", "1")
    monkeypatch.setenv("ACCORD_TCP_DEVICE_VERIFY", "1")
    monkeypatch.setenv("ACCORD_TCP_FLUSH_US", "500")
    monkeypatch.setenv("ACCORD_TCP_DEVICE", "cpu")
    out = tcp_cluster_txns()
    stores = out["stores"]
    assert len(stores) == 3
    assert all(type(s) is DeviceCommandStore and s.device.type == "cpu"
               and s.verify for s in stores)
    assert sum(s.device_hits for s in stores) > 0, \
        "no scan was device-served on the TCP host"
    assert not any(s.device_disabled for s in stores)
    err = capsys.readouterr().err
    assert "uncaught:" not in err and "handled:" not in err, err


@pytest.mark.slow
def test_tcp_lane_three_node_processes_on_cpu():
    """``python -m accord_tpu_torch.bench --config tcp`` at 60 ops on the
    CPU: three node processes, verified, every node on its device tier and
    on the native tier."""
    out = subprocess.run(
        [sys.executable, "-m", "accord_tpu_torch.bench", "--config", "tcp",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=600, env={**os.environ, "ACCORD_BENCH_TCP_OPS": "60",
                          "ACCORD_PROFILE": "1"})
    assert out.returncode == 0, out.stderr[-4000:]
    for bad in ("Traceback", "uncaught:", "handled:"):
        assert bad not in out.stderr, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["verified"] == "strict-serializable"
    assert line["ops"] == 60 and line["acked"] > 54, line
    assert line["device"] == "cpu" and line["value"] is None
    assert len(line["per_node"]) == 3
    for node in line["per_node"]:
        assert node["native"] == {"sorted_arrays": "native", "cfk": "native",
                                  "wire": "native"}, node
        laps = node["laps"]
        assert laps["deps_kernel"] > 0, node
        assert laps["deps_kernel"] + laps.get("recovery_kernel", 0) == \
            node["device"]["device_batches"], node


@pytest.mark.slow
def test_maelstrom_runner_three_processes():
    from accord_tpu_torch.host.runner import MaelstromRunner
    runner = MaelstromRunner(n_nodes=3, seed=7)
    try:
        runner.init_all()
        stats = runner.run_workload(n_ops=25, n_keys=6)
        assert stats["acked"] >= 20, stats
        assert runner.check_strict_serializability(n_keys=6) == \
            stats["acked"]
    finally:
        runner.close()
