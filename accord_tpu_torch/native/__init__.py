"""Native tier: C++ kernels for the protocol engine's hottest host loops.

Built lazily on first import: each source under this package is compiled
with the ambient C++ toolchain into a cached shared object next to this
file and loaded as its own module — `_sorted_arrays.cpp` (the
SortedArrays/CINTIA kernels, `get()`) and `_wire_codec.cpp` (the binary
wire frame codec, `get_wire()`).  Absence of a compiler (or any build/load
failure) degrades silently to the pure-Python tier — the implementations
are behaviourally identical (tests/test_sorted_arrays.py runs against
whichever is active, test_native.py cross-checks the sorted-array tiers,
and tests/test_wire_roundtrip.py pins the wire codec tiers byte-identical).

Rebuilds happen automatically when a source is newer than its cached
object.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig

AVAILABLE = False
_mod = None
_wire_mod = None
_wire_tried = False
_cfk_mod = None
_cfk_tried = False


def _build_and_load(src_name: str, mod_name: str):
    here = os.path.dirname(__file__)
    src = os.path.join(here, src_name)
    out = os.path.join(here, f"{mod_name}_{sys.version_info.major}"
                             f"{sys.version_info.minor}.so")
    if not os.path.exists(out) \
            or os.path.getmtime(out) < os.path.getmtime(src):
        include = sysconfig.get_paths()["include"]
        cxx = os.environ.get("CXX", "g++")
        # per-process temp name: concurrent first imports (multi-process
        # runner, pytest-xdist) must not interleave writes before the
        # atomic replace
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [cxx, "-O2", "-shared", "-fPIC", f"-I{include}", src, "-o",
               tmp]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    spec = importlib.util.spec_from_file_location(mod_name, out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


if os.environ.get("ACCORD_NO_NATIVE", "") != "1":
    try:
        _mod = _build_and_load("_sorted_arrays.cpp", "_accord_native")
        AVAILABLE = True
    except Exception:  # noqa: BLE001 — any failure means Python tier
        _mod = None
        AVAILABLE = False


def get():
    """The native sorted-array module, or None (Python tier)."""
    return _mod


def get_wire():
    """The native wire-codec module, or None (Python tier).  Built on
    first call rather than at import: only frame-transport hosts pay the
    (cached) compile, not every `import accord_tpu_torch.native`."""
    global _wire_mod, _wire_tried
    if not _wire_tried:
        _wire_tried = True
        if os.environ.get("ACCORD_NO_NATIVE", "") != "1":
            try:
                _wire_mod = _build_and_load("_wire_codec.cpp",
                                            "_accord_wire")
            except Exception:  # noqa: BLE001 — Python tier fallback
                _wire_mod = None
    return _wire_mod


def get_cfk():
    """The native CommandsForKey core (_cfk_core.cpp), or None (Python
    tier).  Built lazily like the wire codec.  Tier selection:
    ``ACCORD_NATIVE=0`` (the CFK-tier knob) or ``ACCORD_NO_NATIVE=1`` (the
    package-wide kill switch) force the bit-identical Python tier; any
    build/load failure degrades to it silently."""
    global _cfk_mod, _cfk_tried
    if not _cfk_tried:
        _cfk_tried = True
        if os.environ.get("ACCORD_NO_NATIVE", "") != "1" \
                and os.environ.get("ACCORD_NATIVE", "") != "0":
            try:
                _cfk_mod = _build_and_load("_cfk_core.cpp", "_accord_cfk")
            except Exception:  # noqa: BLE001 — Python tier fallback
                _cfk_mod = None
    return _cfk_mod
