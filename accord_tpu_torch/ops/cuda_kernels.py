"""Hand-written CUDA kernels for Hopper: build, loading, wrappers, counters.

The counterpart of ``accord_tpu/ops/pallas_kernels.py``:

* K1, the deps tile (``csrc/deps_tile.cu``), replaces ``_deps_kernel``
  (entry ``batched_active_deps_pallas``);
* K2, the wavefront (``csrc/wavefront.cu``), replaces ``_waves_kernel``
  (entry ``execution_waves_pallas``);
* K4, the key-set windows (``csrc/keyset_windows.cu``), replaces
  ``_keyset_windows_kernel`` (entry ``keyset_windows_pallas``) on the TPC-C
  replay lane;
* K5, the range stab counts (``csrc/range_stab.cu``), is the counterpart of
  an XLA fusion, not of a Pallas kernel: ``range_kernel.range_stab_counts``,
  whose [Q, N] compare-and-count plain PyTorch cannot fuse, on the
  rangestress lane.  It indexes the queries and streams the intervals once
  (four steps in five launches: sort, stream, combine, correct).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, into ``accord_tpu_torch/_build/`` under a
name keyed by a hash of the source and the flags, and bound with ctypes.
Importing this module builds nothing.

Every wrapper takes the plain PyTorch version (ops/deps_kernel.py,
ops/wavefront.py, ops/keyset.py, ops/range_kernel.py) when its tensors lie
on the CPU, and only then: on CUDA tensors it launches its kernel or raises.  Each launch's error
code is checked, and each wrapper adds one to its kernel's ``launches``
count where it launches, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

from accord_tpu_torch.ops import deps_kernel, keyset, range_kernel, wavefront
from accord_tpu_torch.utils.timing import median_ms

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


class Kernel:
    """One CUDA source built into one shared library, loaded at first use.

    `signatures` maps each exported C function to (argtypes, restype).
    `launches` counts the launches its wrappers made."""

    def __init__(self, name: str, source: str,
                 signatures: Dict[str, Tuple[tuple, object]]):
        self.name = name
        self.source = CSRC / source
        self.signatures = signatures
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
        """Start nvcc for this source unless its library exists; returns
        (process, temporary output, final path) or None."""
        path = self.library_path()
        if path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, path

    def finish_build(self, proc: subprocess.Popen, tmp: Path, path: Path,
                     timeout_s: float) -> None:
        try:
            out, _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise RuntimeError(f"nvcc timed out building {self.source.name}")
        self.build_log = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {self.source.name}:\n{out}")
        os.replace(tmp, path)  # atomic: concurrent builds agree on the file

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(str(self.library_path()))
            for fn, (argtypes, restype) in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            self._lib = lib
        return self._lib

    def check(self, code: int) -> None:
        if code != 0:
            msg = getattr(self.lib(), f"{self.name}_error_string")(code)
            raise RuntimeError(f"{self.name} launch failed: CUDA error {code} "
                               f"({msg.decode()})")


DEPS_TILE = Kernel("deps_tile", "deps_tile.cu", {
    "deps_tile_launch": ((_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _P, _P, _P, _I, _P), _I),
    "deps_tile_error_string": ((_I,), ctypes.c_char_p),
})
WAVEFRONT = Kernel("wavefront", "wavefront.cu", {
    "wavefront_launch": ((_P, _P, _I, _P, _P, _P, _P), _I),
    "wavefront_scratch_words": ((_I,), ctypes.c_longlong),
    "wavefront_error_string": ((_I,), ctypes.c_char_p),
})
KEYSET_WINDOWS = Kernel("keyset_windows", "keyset_windows.cu", {
    "keyset_windows_plan": ((_I, _I, ctypes.POINTER(ctypes.c_longlong),
                             ctypes.POINTER(ctypes.c_int)), _I),
    "keyset_windows_launch": ((_P, _P, _I, _I, _I, _P, _P, _P, _P, _P), _I),
    "keyset_windows_error_string": ((_I,), ctypes.c_char_p),
})
RANGE_STAB = Kernel("range_stab", "range_stab.cu", {
    "range_stab_launch": ((_P, _P, ctypes.c_longlong, _P, _P, _I, _P, _P, _I,
                           _P), _I),
    "range_stab_scratch_words": ((ctypes.c_longlong, _I), ctypes.c_longlong),
    "range_stab_tile": ((_I,), _I),
    "range_stab_error_string": ((_I,), ctypes.c_char_p),
})
KERNELS = (DEPS_TILE, WAVEFRONT, KEYSET_WINDOWS, RANGE_STAB)
# K4's range (csrc/keyset_windows.cu): key slots B*P a window, P >= 1.  Up
# to 16 keys a row and 22,528 slots a window's index lives in one block's
# shared memory; above, in global scratch (the large-window kernel).
KEYSET_MAX_SLOTS = 1 << 22


def build(kernels: Iterable[Kernel] = KERNELS,
          timeout_s: float = 600.0) -> Dict[str, float]:
    """Compile every kernel whose library is missing, one nvcc per source,
    all started together.  -> {name: seconds until its library was ready}
    (0.0 for one already built)."""
    t0 = time.perf_counter()
    started = {k.name: (k, k.start_build()) for k in kernels}
    seconds = {}
    for name, (k, job) in started.items():
        if job is not None:
            k.finish_build(*job, timeout_s=timeout_s)
        seconds[name] = time.perf_counter() - t0 if job is not None else 0.0
    return seconds


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _cuda_device(tensors) -> Optional[torch.device]:
    """The one device of `tensors`: None when all lie on the CPU, the CUDA
    device when all lie on it; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _require(t: torch.Tensor, name: str, dtype: torch.dtype,
             shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' non-contiguous'}")


class _DepsTileShape:
    """K1's checked inputs: S shards of Ks keys and E entries over B rows
    (S = 1 for a flat window) and the shape of the mask it writes."""

    __slots__ = ("dev", "s", "ks", "b", "e", "mask_shape")

    def __init__(self, touches, entry_key, entry_rank, entry_eat_rank,
                 entry_status, entry_kind, succ_w, txn_rank,
                 txn_witness_mask):
        self.dev = _cuda_device((touches, entry_key, entry_rank,
                                 entry_eat_rank, entry_status, entry_kind,
                                 succ_w, txn_rank, txn_witness_mask))
        if touches.dim() != 2 or entry_rank.dim() not in (1, 2):
            raise ValueError(f"expected touches [B, K] and entry arrays [E] "
                             f"or [S, E], got {tuple(touches.shape)} and "
                             f"{tuple(entry_rank.shape)}")
        b, k = touches.shape
        stacked = entry_rank.dim() == 2
        s = entry_rank.shape[0] if stacked else 1
        e = entry_rank.shape[-1]
        ks = deps_kernel.shard_width(touches, s)
        _require(touches, "touches", torch.bool, (b, k))
        for name, t in (("entry_key", entry_key), ("entry_rank", entry_rank),
                        ("entry_eat_rank", entry_eat_rank),
                        ("entry_status", entry_status),
                        ("entry_kind", entry_kind), ("succ_w", succ_w)):
            _require(t, name, torch.int32, tuple(entry_rank.shape))
        _require(txn_rank, "txn_rank", torch.int32, (b,))
        _require(txn_witness_mask, "txn_witness_mask", torch.int32, (b,))
        if (b + 31) // 32 > 65535 or s > 65535 or max(e, k) >= 2 ** 31:
            raise ValueError(f"window too large for the deps tile: S={s} "
                             f"B={b} E={e} K={k}")
        self.s, self.ks, self.b, self.e = s, ks, b, e
        self.mask_shape = (s, b, e) if stacked else (b, e)

    def empty(self) -> bool:
        return 0 in (self.b, self.e, self.ks)

    def buffers(self):
        """(packed touches, mask, counts), uninitialised: K1 writes all
        three (its packing launch zeroes the counts)."""
        words = ((self.b + 31) // 32) * self.s * self.ks
        return (torch.empty(words, dtype=torch.int32, device=self.dev),
                torch.empty(self.mask_shape, dtype=torch.bool, device=self.dev),
                torch.empty(self.b, dtype=torch.int32, device=self.dev))


def _deps_tile_launch(args, shape, packed, dep, count, phases):
    (touches, entry_key, entry_rank, entry_eat_rank, entry_status, entry_kind,
     succ_w, txn_rank, txn_witness_mask) = args
    lib = DEPS_TILE.lib()
    with torch.cuda.device(dep.device):
        stream = torch.cuda.current_stream(dep.device).cuda_stream
        code = lib.deps_tile_launch(
            touches.data_ptr(), shape.s, shape.ks, entry_key.data_ptr(),
            entry_rank.data_ptr(), entry_eat_rank.data_ptr(),
            entry_status.data_ptr(), entry_kind.data_ptr(), succ_w.data_ptr(),
            txn_rank.data_ptr(), txn_witness_mask.data_ptr(), shape.b,
            shape.e, packed.data_ptr(), dep.data_ptr(), count.data_ptr(),
            phases, stream)
    DEPS_TILE.check(code)
    DEPS_TILE.launches += 1


def deps_tile_cuda(touches, entry_key, entry_rank, entry_eat_rank,
                   entry_status, entry_kind, succ_w, txn_rank,
                   txn_witness_mask):
    """K1 on CUDA tensors, its plain version on CPU tensors.

    Entry arrays [E] (a flat window, ``deps_kernel.deps_tile``) ->
    (dep_mask[B, E] bool, dep_count[B] int32).  Entry arrays [S, E] in the
    sharded key-block layout (touches [B, S*Ks], keys local to their shard,
    ``deps_kernel.sharded_deps_tile``) -> (dep_mask[S, B, E] bool,
    dep_count[B] int32 summed over the shards), in one launch pair for all S
    shards."""
    args = (touches, entry_key, entry_rank, entry_eat_rank, entry_status,
            entry_kind, succ_w, txn_rank, txn_witness_mask)
    if _cuda_device(args) is None:
        plain = deps_kernel.sharded_deps_tile if entry_rank.dim() == 2 \
            else deps_kernel.deps_tile
        return plain(*args)
    shape = _DepsTileShape(*args)
    if shape.empty():
        return (torch.zeros(shape.mask_shape, dtype=torch.bool, device=shape.dev),
                torch.zeros(shape.b, dtype=torch.int32, device=shape.dev))
    # touches packed to bits, 32 txn rows per word (see csrc/deps_tile.cu)
    packed, dep, count = shape.buffers()
    _deps_tile_launch(args, shape, packed, dep, count, 3)
    return dep, count


def deps_tile_phases(*args):
    """K1's two launches apart, for timing them: -> (pack, tile), two
    functions of no argument that launch the packing pass (which zeroes the
    counts) and the tile on buffers of their own.  The tile reads what the
    last pack wrote; each launch counts as one of K1's.  CUDA tensors only
    (a flat or a stacked window), and a non-empty window."""
    shape = _DepsTileShape(*args)
    if shape.dev is None or shape.empty():
        raise ValueError("deps_tile_phases times K1 on a non-empty window of "
                         "CUDA tensors")
    packed, dep, count = shape.buffers()
    return tuple(
        (lambda ph=ph: _deps_tile_launch(args, shape, packed, dep, count, ph))
        for ph in (1, 2))


def batched_active_deps_cuda(entry_rank, entry_eat_rank, entry_key,
                             entry_status, entry_kind, txn_rank,
                             txn_witness_mask, touches):
    """Counterpart of ``batched_active_deps_pallas``: succ_w (a sort and a
    segmented scan) stays plain torch, the tile runs in K1 (on CPU tensors
    in its plain version, so this is ``deps_kernel.batched_active_deps``).
    Entry arrays [E] give the flat [B, E] mask; entry arrays [S, E] in the
    sharded key-block layout give [S, B, E] and the counts summed over the
    shards, from one succ_w pass and one K1 launch pair for all S."""
    if entry_rank.dim() == 2:
        succ_w = deps_kernel.sharded_successor_write_eat(
            entry_rank, entry_eat_rank, entry_key, entry_status, entry_kind,
            deps_kernel.shard_width(touches, entry_rank.shape[0]))
    else:
        succ_w = deps_kernel.successor_write_eat(
            entry_rank, entry_eat_rank, entry_key, entry_status, entry_kind)
    return deps_tile_cuda(touches, entry_key, entry_rank, entry_eat_rank,
                          entry_status, entry_kind, succ_w, txn_rank,
                          txn_witness_mask)


def wavefront_bits_in_smem(b: int) -> bool:
    """Whether K2 keeps a B-row window's working set (its packed matrix) in
    shared memory on the current card (otherwise in global scratch)."""
    return WAVEFRONT.lib().wavefront_scratch_words(b) == 0


def execution_waves_cuda(dep_bb, txn_rank=None, stats=None):
    """Counterpart of ``execution_waves_pallas``: K2 on a CUDA tensor (every
    B), ``wavefront.execution_waves`` on a CPU tensor.  -> wave[B] int32.

    `txn_rank` (int32 [B], optional) orders the rows: when every edge points
    to an earlier row in that order (as ``conflict_edges`` makes them), K2
    takes its forward pass, otherwise its fixpoint; the result is the same
    function of `dep_bb` either way, so the CPU path ignores it.  `stats`,
    an int32 [3] CUDA tensor, receives the kernel's own account: 1 for the
    forward pass (0 for the fixpoint), 1 when it sorted the ranks, and the
    steps of its chain (tiles of 32 rows, or fixpoint iterations)."""
    given = (dep_bb,) + tuple(t for t in (txn_rank, stats) if t is not None)
    dev = _cuda_device(given)
    if dev is None:
        if stats is not None:
            raise ValueError("stats are counted by the kernel: pass CUDA tensors")
        return wavefront.execution_waves(dep_bb)
    if dep_bb.dim() != 2:
        raise ValueError(f"dep_bb: expected [B, B], got {tuple(dep_bb.shape)}")
    b = dep_bb.shape[0]
    _require(dep_bb, "dep_bb", torch.bool, (b, b))
    if txn_rank is not None:
        _require(txn_rank, "txn_rank", torch.int32, (b,))
    if stats is not None:
        _require(stats, "stats", torch.int32, (3,))
    if b >= 2 ** 31 // max(1, (b + 31) // 32):
        raise ValueError(f"window too large for the wavefront: B={b}")
    wave = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return wave
    lib = WAVEFRONT.lib()
    with torch.cuda.device(dev):
        words = lib.wavefront_scratch_words(b)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.wavefront_launch(
            dep_bb.data_ptr(), None if txn_rank is None else txn_rank.data_ptr(),
            b, scratch.data_ptr() if words else None, wave.data_ptr(),
            None if stats is None else stats.data_ptr(), stream)
    WAVEFRONT.check(code)
    WAVEFRONT.launches += 1
    return wave


def keyset_windows_in_smem(b: int, p: int) -> bool:
    """Whether K4 takes windows of B rows of P keys in its shared-memory
    kernel on the current card (otherwise in its large-window kernel)."""
    words, in_smem = ctypes.c_longlong(0), ctypes.c_int(0)
    KEYSET_WINDOWS.check(KEYSET_WINDOWS.lib().keyset_windows_plan(
        p, b, ctypes.byref(words), ctypes.byref(in_smem)))
    return bool(in_smem.value)


def keyset_windows_cuda(txn_keys, txn_rank, stats=None):
    """Counterpart of ``keyset_windows_pallas``: K4 on CUDA tensors,
    ``keyset.keyset_windows`` on CPU tensors.  txn_keys [W, B, P] int32
    (negative = pad; on the card P >= 1 and B*P <= 2^22), txn_rank [W, B]
    int32 (negative = pad) -> (in_window_edges [W] int32, max_wave [W]
    int32).  `stats`, an int32 [W, 3] CUDA tensor, receives the kernel's own
    counts for each window: the slots of its index (the shared-memory
    kernel's are the rows' shared keys, the large-window kernel's every
    distinct key of a valid row), its pair checks and its wave sweeps."""
    args = (txn_keys, txn_rank) + (() if stats is None else (stats,))
    dev = _cuda_device(args)
    if dev is None:
        if stats is not None:
            raise ValueError("stats are counted by the kernel: pass CUDA tensors")
        return keyset.keyset_windows(txn_keys, txn_rank)
    if txn_keys.dim() != 3:
        raise ValueError(f"txn_keys: expected [W, B, P], got "
                         f"{tuple(txn_keys.shape)}")
    w, b, p = txn_keys.shape
    _require(txn_keys, "txn_keys", torch.int32, (w, b, p))
    _require(txn_rank, "txn_rank", torch.int32, (w, b))
    if stats is not None:
        _require(stats, "stats", torch.int32, (w, 3))
    if not (p >= 1 and 1 <= b <= KEYSET_MAX_SLOTS // p):
        raise ValueError(
            f"K4 takes P >= 1 keys a row and 1 <= B*P <= {KEYSET_MAX_SLOTS} "
            f"key slots a window (the large-window kernel's scratch is 24 "
            f"bytes a slot): got B={b} P={p}")
    edges = torch.empty(w, dtype=torch.int32, device=dev)
    max_wave = torch.empty(w, dtype=torch.int32, device=dev)
    if w == 0:
        return edges, max_wave
    lib = KEYSET_WINDOWS.lib()
    words, in_smem = ctypes.c_longlong(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        KEYSET_WINDOWS.check(lib.keyset_windows_plan(
            p, b, ctypes.byref(words), ctypes.byref(in_smem)))
        scratch = torch.empty(w * words.value, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.keyset_windows_launch(
            txn_keys.data_ptr(), txn_rank.data_ptr(), w, b, p,
            scratch.data_ptr(), edges.data_ptr(), max_wave.data_ptr(),
            None if stats is None else stats.data_ptr(), stream)
    KEYSET_WINDOWS.check(code)
    KEYSET_WINDOWS.launches += 1
    return edges, max_wave


def _range_stab_shape(starts, ends, q_starts, q_ends):
    """Checks K5's inputs -> (device or None for the CPU, N, Q)."""
    dev = _cuda_device((starts, ends, q_starts, q_ends))
    if dev is None:
        return None, starts.shape[0], q_starts.shape[0]
    if starts.dim() != 1 or q_starts.dim() != 1:
        raise ValueError(f"expected [N] intervals and [Q] queries, got "
                         f"{tuple(starts.shape)} and {tuple(q_starts.shape)}")
    n, q = starts.shape[0], q_starts.shape[0]
    for name, t, size in (("starts", starts, n), ("ends", ends, n),
                          ("q_starts", q_starts, q), ("q_ends", q_ends, q)):
        _require(t, name, torch.int32, (size,))
    if max(n, q) >= 2 ** 31:
        raise ValueError(f"too many intervals or queries for the range stab "
                         f"kernel: N={n} Q={q}")
    return dev, n, q


def _range_stab_launch(args, n, q, scratch, counts, phases):
    starts, ends, q_starts, q_ends = args
    lib = RANGE_STAB.lib()
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream(counts.device).cuda_stream
        code = lib.range_stab_launch(
            starts.data_ptr(), ends.data_ptr(), n, q_starts.data_ptr(),
            q_ends.data_ptr(), q, scratch.data_ptr(), counts.data_ptr(),
            phases, stream)
    RANGE_STAB.check(code)
    RANGE_STAB.launches += 1


def _range_stab_buffers(dev, n, q):
    scratch = torch.empty(RANGE_STAB.lib().range_stab_scratch_words(n, q),
                          dtype=torch.int32, device=dev)
    return scratch, torch.empty(q, dtype=torch.int32, device=dev)


def range_stab_counts_cuda(starts, ends, q_starts, q_ends):
    """``range_kernel.range_stab_counts`` in K5 on CUDA tensors, in its plain
    version on CPU tensors: int32 interval bounds [N] and query bounds [Q]
    -> int32 [Q] intersect counts.  Any N >= 0 and Q >= 0, no padding."""
    args = (starts, ends, q_starts, q_ends)
    dev, n, q = _range_stab_shape(*args)
    if dev is None:
        return range_kernel.range_stab_counts(*args)
    if q == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    scratch, counts = _range_stab_buffers(dev, n, q)  # all written by K5
    _range_stab_launch(args, n, q, scratch, counts, 15)
    return counts


RANGE_STAB_PHASES = ("sort", "stream", "combine", "correct")


def range_stab_tile(q: int) -> int:
    """Queries in each of K5's query tiles for Q queries (the tiles are as
    even as its shared memory allows)."""
    return RANGE_STAB.lib().range_stab_tile(q)


def range_stab_phases(starts, ends, q_starts, q_ends, reps=15,
                      per_batch=10):
    """K5's four steps timed apart on CUDA tensors -> {phase: median ms
    (CUDA events)} for the sort (two launches), the stream, the combine and
    the correction.  Before each phase's timing one whole count runs on the
    same buffers, so the phase reads what the steps before it wrote; every
    call of a step counts as one of K5's launches."""
    args = (starts, ends, q_starts, q_ends)
    dev, n, q = _range_stab_shape(*args)
    if dev is None or q == 0:
        raise ValueError("range_stab_phases times K5 on CUDA tensors with "
                         "Q >= 1")
    scratch, counts = _range_stab_buffers(dev, n, q)
    times = {}
    for bit, name in enumerate(RANGE_STAB_PHASES):
        _range_stab_launch(args, n, q, scratch, counts, 15)
        times[name] = median_ms(
            lambda bit=bit: _range_stab_launch(args, n, q, scratch, counts,
                                               1 << bit),
            reps=reps, per_batch=per_batch)
    return times
