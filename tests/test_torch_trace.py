"""The port's trace spans and store counters on the CPU.

A ``DeviceCommandStore(device="cpu")`` driven through seeded windows with
the span hook (``obs/profiler.set_tracer``) installed: every span the
store and ``local/`` open appears in ``torch.profiler``'s trace, nested as
the sites nest; each profiler lap brackets exactly the spans that tile
it; the counters match a window counted by hand; and with no tracer the
sites record nothing.

Every test here is marked ``slow``: the tier-1 run's budget guard
(``tests/conftest.py``) has no room for another unmarked test.  They run
with ``python -m pytest tests/test_torch_trace.py -m slow``.
"""

import pytest
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from accord_tpu_torch.impl.device_store import DeviceCommandStore
from accord_tpu_torch.obs import profiler as obs_profiler
from accord_tpu_torch.obs.profiler import Profiler, set_tracer, span
from accord_tpu_torch.obs.registry import Registry
from accord_tpu_torch.primitives.timestamp import Domain, TxnKind
from accord_tpu_torch.workload import (StoreNode, StorePlanRunner, store_kit,
                                       store_plan)

pytestmark = pytest.mark.slow

SPAN = (0, 1 << 20)
# each span and the spans it may open inside (the innermost accord.* range
# around it); None is the top level
PARENTS = {
    "accord.flush": {None},
    **{f"accord.deps.{p}": {"accord.flush"}
       for p in ("snapshot", "encode", "upload", "launch", "download",
                 "decode", "install")},
    **{f"accord.waves.{p}": {"accord.flush"}
       for p in ("encode", "upload", "launch", "download")},
    "accord.recovery": {"accord.flush"},
    "accord.range": {"accord.flush"},
    **{f"accord.op.{p}": {"accord.flush"}
       for p in ("preaccept", "accept", "commit", "apply")},
    "accord.op.deps": {"accord.flush"},
    # register runs from the transitions, a recovery's witness (which
    # opens no span) and an Apply's execution
    "accord.op.index": {"accord.flush", "accord.op.preaccept",
                        "accord.op.accept", "accord.op.commit",
                        "accord.op.apply", "accord.op.execute"},
    "accord.op.waiting_on": {"accord.op.commit", "accord.op.apply"},
    # execution runs from the transitions, WaitingOn set-up, the index's
    # fired callbacks and the notifications of an earlier execution
    "accord.op.execute": {"accord.op.commit", "accord.op.apply",
                          "accord.op.waiting_on", "accord.op.index",
                          "accord.op.execute"},
}
# each lap and the spans that tile it, in order
LAPS = {
    "deps_encode": ["accord.deps.snapshot", "accord.deps.encode",
                    "accord.deps.upload"],
    "deps_kernel": ["accord.deps.launch", "accord.deps.download"],
    "deps_decode": ["accord.deps.decode"],
    "wavefront_encode": ["accord.waves.encode", "accord.waves.upload"],
    "wavefront_kernel": ["accord.waves.launch", "accord.waves.download"],
}


def _runner(plan, profiled=False):
    node = StoreNode(store_kit())
    store = DeviceCommandStore(0, node, node.kit.Ranges.of(SPAN),
                               verify=True, device="cpu")
    if profiled:
        store.profiler = Profiler(Registry(), sample_n=1)
    return StorePlanRunner(store, node, plan)


def _plan():
    # recovery probes and range txns among the lifecycle's ops, so every
    # arm of the flush runs
    return store_plan(3, n_keys=12, n_txns=160)


def _accord_events(prof):
    return [e for e in prof.events() if e.name.startswith("accord.")]


def _innermost(event):
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith("accord."):
        parent = parent.cpu_parent
    return None if parent is None else parent.name


def test_spans_appear_nested_in_the_profilers_trace():
    runner = _runner(_plan())
    set_tracer(record_function)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            runner.run()
    finally:
        set_tracer(None)
    events = _accord_events(prof)
    assert {e.name for e in events} == set(PARENTS)
    wrong = {(e.name, _innermost(e)) for e in events
             if _innermost(e) not in PARENTS[e.name]}
    assert not wrong
    assert not runner.store.device_disabled


class _Log:
    """A tracer and a profiler whose clock logs, in order, each span's
    entry and exit, each lap's start and each lap's end."""

    def __init__(self):
        self.log = []
        self.now = 0.0

    def tracer(self, name):
        log = self.log

        class _Span:
            def __enter__(self):
                log.append(("enter", name))

            def __exit__(self, *exc):
                log.append(("exit", name))
        return _Span()

    def profiler(self):
        log = self.log

        class _Laps(Profiler):
            __slots__ = ()

            def begin(self):
                t = super().begin()
                log.append(("begin", None))
                return t

            def lap(self, t, kernel, fence=None):
                t = super().lap(t, kernel, fence)
                log.append(("lap", kernel))
                return t

        def clock():
            self.now += 1.0
            return self.now
        return _Laps(Registry(), sample_n=1, clock=clock)


def test_laps_bracket_exactly_their_spans():
    runner = _runner(_plan())
    log = _Log()
    runner.store.profiler = log.profiler()
    set_tracer(log.tracer)
    try:
        runner.run()
    finally:
        set_tracer(None)
    # each lap runs from the chain's begin or the lap before it; the deps
    # and wave phases it holds are the spans entered since, each exited
    tiles, opened, inside = [], [], 0
    for kind, name in log.log:
        phase = name is not None and name.startswith(("accord.deps.",
                                                      "accord.waves."))
        if kind == "begin":
            opened = []
        elif kind == "enter" and phase:
            assert inside == 0, f"{name} opened inside another phase"
            opened.append(name)
            inside += 1
        elif kind == "exit" and phase:
            inside -= 1
        elif kind == "lap":
            assert inside == 0, f"the {name} lap ended inside a span"
            if name in LAPS:
                tiles.append((name, opened))
            opened = []
    assert {lap for lap, _ in tiles} == set(LAPS)
    for lap, names in tiles:
        assert names == LAPS[lap], (lap, names)
    # after the deps chain's last lap: the probes' install, and no lap
    for i, entry in enumerate(log.log):
        if entry == ("lap", "deps_decode"):
            assert log.log[i + 1:i + 3] == [
                ("enter", "accord.deps.install"),
                ("exit", "accord.deps.install")]


def test_counters_match_a_window_counted_by_hand():
    # A writes keys 10 and 20, B key 20, C keys 10 and 20: C's probe reads
    # A on both keys and B on key 20; A and B apply in one window
    write, key = int(TxnKind.WRITE), int(Domain.KEY)
    txns = [(write, key, 1001, 0, (10, 20)), (write, key, 1002, 0, (20,)),
            (write, key, 1003, 0, (10, 20))]
    windows = [[("preaccept", 0), ("preaccept", 1)], [("preaccept", 2)],
               [("commit", 0), ("commit", 1)], [("apply", 0), ("apply", 1)]]
    runner = _runner((txns, windows))
    runner.run()
    store = runner.store
    # two deps flushes, each padded to 128 entries, 128 probes and 128
    # keys: five int32 entry arrays, three int32 probe arrays and the
    # [128, 128] bool touches out, the [128, 128] bool mask back; one wave
    # plan of 128 rows and 128 keys: three int32 arrays and the bool
    # touches out, 128 int32 waves back
    deps_out = 5 * 128 * 4 + 3 * 128 * 4 + 128 * 128
    waves_out = 3 * 128 * 4 + 128 * 128
    assert store.device_copy_bytes == {"h2d": 2 * deps_out + waves_out,
                                       "d2h": 2 * 128 * 128 + 128 * 4}
    # the first flush's index is empty; the second's holds A twice, B once
    assert store.device_encoded_entries == 3
    # A's probe and C's are served (B's key changed under it: a version
    # miss); A's has no deps, C's three
    assert (store.device_hits, store.device_misses) == (2, 1)
    assert store.device_served_deps == 3
    depths = store.device_wave_depths
    assert (depths.count, depths.sum) == (1, 2)
    assert store.device_wave_max_depth == 2


def test_no_tracer_records_nothing():
    assert obs_profiler._tracer is None
    assert span("accord.flush") is span("accord.op.deps")
    runner = _runner(_plan(), profiled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outside"):
            runner.run()
    assert _accord_events(prof) == []
    assert {e.name for e in prof.events()} >= {"outside"}
    # the laps still run, and the waterfall is gone from the registry
    snap = runner.store.profiler.registry.snapshot()
    assert snap["histograms"]["accord_profile_kernel_us"]
    assert "accord_profile_window_us" not in snap["histograms"]
    assert "accord_profile_windows_sampled_total" not in snap["counters"]
