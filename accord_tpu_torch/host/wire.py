"""JSON wire codec for every Accord message and primitive.

Reference: accord-maelstrom/Json.java — gson adapters per type. Our
counterpart is a registry-driven structural codec: every class defined in
the framework's message/primitive/data-plane modules is encodable by
walking its slots/dict, with enums by value and exceptions by name. The
encoding is plain JSON (Maelstrom requires it), self-describing via `$c`
class tags, and round-trip-exact for every verb in the MessageType registry
(tests/test_host.py proves it).

Decode reconstructs via `__new__` + setattr — constructor revalidation is
the sender's job; the wire is trusted only as far as the registry (unknown
class tags are rejected, so a peer cannot instantiate arbitrary types).
"""

from __future__ import annotations

import enum
import importlib
from typing import Any, Dict, Type

_MODULES = [
    "accord_tpu_torch.primitives.timestamp",
    "accord_tpu_torch.primitives.keys",
    "accord_tpu_torch.primitives.deps",
    "accord_tpu_torch.primitives.latest_deps",
    "accord_tpu_torch.primitives.txn",
    "accord_tpu_torch.primitives.writes",
    "accord_tpu_torch.local.status",
    "accord_tpu_torch.local.command",
    # only AcceptOutcome/ApplyOutcome enums: AcceptNack carries its reason
    # (found by tests/test_wire_roundtrip.py — the nack encoded but could
    # not decode, so a slow-path reject crashed the receiving host)
    "accord_tpu_torch.local.commands",
    "accord_tpu_torch.messages.base",
    "accord_tpu_torch.messages.preaccept",
    "accord_tpu_torch.messages.accept",
    "accord_tpu_torch.messages.commit",
    "accord_tpu_torch.messages.apply_msg",
    "accord_tpu_torch.messages.read",
    "accord_tpu_torch.messages.recover",
    "accord_tpu_torch.messages.invalidate_msg",
    "accord_tpu_torch.messages.getdeps",
    "accord_tpu_torch.messages.ephemeral",
    "accord_tpu_torch.messages.wait",
    "accord_tpu_torch.messages.checkstatus",
    "accord_tpu_torch.messages.propagate",
    "accord_tpu_torch.messages.durability",
    "accord_tpu_torch.messages.epoch",
    "accord_tpu_torch.messages.maxconflict",
    "accord_tpu_torch.messages.multi",
    "accord_tpu_torch.messages.audit",
    "accord_tpu_torch.messages.admin",
    "accord_tpu_torch.messages.paging",
    "accord_tpu_torch.impl.list_store",
    "accord_tpu_torch.coordinate.errors",
    "accord_tpu_torch.pipeline.backpressure",
    # QosRejected: the admission tier's retriable nack must survive the
    # wire (retry_after_us/tenant/priority re-attached via wire_extra)
    "accord_tpu_torch.qos.admission",
    "accord_tpu_torch.utils.interval_map",
    # worker-pipe frames for the per-shard runtime (shard/): the
    # supervisor<->worker duplex pipe speaks the same codec as the network
    "accord_tpu_torch.shard.frames",
]

_CLASSES: Dict[str, Type] = {}
_ENUMS: Dict[str, Type] = {}
import threading as _threading

_REGISTRY_LOCK = _threading.Lock()

# compact fast paths for the primitives that dominate every frame (a deps
# list is hundreds of TxnIds; the structural walk also serialises cached
# comparison slots).  Exact-type dispatch: subclasses fall through to the
# structural codec.
from accord_tpu_torch.primitives.keys import (Key as _Key, Keys as _Keys,
                                        RoutingKey as _RoutingKey,
                                        RoutingKeys as _RoutingKeys)
from accord_tpu_torch.primitives.timestamp import (Ballot as _Ballot,
                                             Timestamp as _Timestamp,
                                             TxnId as _TxnId)

_TS_TAGS = {_Timestamp: "$T", _TxnId: "$I", _Ballot: "$B"}
_TS_DECODE = {"$T": _Timestamp, "$I": _TxnId, "$B": _Ballot}
_SLOTS_CACHE: Dict[Type, list] = {}


def _registry() -> Dict[str, Type]:
    if _CLASSES:
        return _CLASSES
    # build-then-publish under a lock: encoders run concurrently (node loop
    # thread + the WAL's group-commit flush thread releasing gated replies,
    # or many bench appenders), and a reader racing a partial in-place
    # population would reject registered types as unknown
    with _REGISTRY_LOCK:
        if _CLASSES:
            return _CLASSES
        classes: Dict[str, Type] = {}
        enums: Dict[str, Type] = {}
        for mod_name in _MODULES:
            mod = importlib.import_module(mod_name)
            for name, obj in vars(mod).items():
                if not isinstance(obj, type) or obj.__module__ != mod_name:
                    continue
                if issubclass(obj, enum.Enum):
                    enums[name] = obj
                else:
                    classes[name] = obj
        _ENUMS.update(enums)
        _CLASSES.update(classes)
    return _CLASSES


def _slots_of(cls: Type):
    out = _SLOTS_CACHE.get(cls)
    if out is None:
        out = []
        for klass in cls.__mro__:
            out.extend(getattr(klass, "__slots__", ()))
        _SLOTS_CACHE[cls] = out
    return out


# hot-path dispatch: one dict lookup on the exact type replaces the old
# isinstance chain (half a million isinstance calls per 400-txn TCP run).
# Types absent from the table (enums, exceptions, registered classes,
# subclasses of the fast-path primitives) take _encode_slow, which keeps
# the original ordering semantics exactly.

def _enc_self(obj):
    return obj


def _enc_ts(obj):
    msb, lsb, node = obj.pack()
    return {_TS_TAGS[type(obj)]: [msb, lsb, node]}


def _enc_key(obj):
    return {"$K": obj.token}


def _enc_rkey(obj):
    return {"$RK": obj.token}


def _enc_keys(obj):
    # hosts may subclass Key for richer identity — those fall through
    # to the structural codec (loud if unregistered) instead of being
    # silently flattened to plain tokens
    if all(type(k) is _Key for k in obj):
        return {"$Ks": [k.token for k in obj]}
    return _encode_slow(obj)


def _enc_rkeys(obj):
    if all(type(k) is _RoutingKey for k in obj):
        return {"$RKs": [k.token for k in obj]}
    return _encode_slow(obj)


def _enc_list(obj):
    return [encode(x) for x in obj]


def _enc_tuple(obj):
    # deps CSR offsets/ids are long int tuples: skip per-element calls
    if all(type(x) is int for x in obj):
        return {"$t": list(obj)}
    return {"$t": [encode(x) for x in obj]}


def _enc_set(obj):
    return {"$s": [encode(x) for x in obj]}


def _enc_dict(obj):
    return {"$d": [[encode(k), encode(v)] for k, v in obj.items()]}


_ENC = {
    type(None): _enc_self, bool: _enc_self, int: _enc_self,
    float: _enc_self, str: _enc_self,
    _Timestamp: _enc_ts, _TxnId: _enc_ts, _Ballot: _enc_ts,
    _Key: _enc_key, _RoutingKey: _enc_rkey,
    _Keys: _enc_keys, _RoutingKeys: _enc_rkeys,
    list: _enc_list, tuple: _enc_tuple,
    set: _enc_set, frozenset: _enc_set,
    dict: _enc_dict,
}


def encode(obj: Any) -> Any:
    f = _ENC.get(type(obj))
    if f is not None:
        return f(obj)
    return _encode_slow(obj)


def _encode_slow(obj: Any) -> Any:
    if isinstance(obj, enum.Enum):  # before int: IntEnum is an int
        return {"$e": type(obj).__name__, "v": encode(obj.value)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [encode(x) for x in obj]
    if isinstance(obj, tuple):
        return _enc_tuple(obj)
    if isinstance(obj, (set, frozenset)):
        return _enc_set(obj)
    if isinstance(obj, dict):
        return _enc_dict(obj)
    if isinstance(obj, BaseException):
        out = {"$x": type(obj).__name__, "msg": str(obj)}
        # exceptions encode by name+message only; ones carrying
        # machine-readable payload (QosRejected's retry_after_us hint)
        # declare it via wire_extra() and get it re-attached on decode
        extra = getattr(obj, "wire_extra", None)
        if extra is not None:
            out["f"] = {k: encode(v) for k, v in extra().items()}
        return out
    _registry()
    cls = type(obj)
    name = cls.__name__
    if name not in _CLASSES:
        raise TypeError(f"unregistered wire type: {cls.__module__}.{name}")
    fields: Dict[str, Any] = {}
    for slot in _slots_of(cls):
        if hasattr(obj, slot):
            fields[slot] = encode(getattr(obj, slot))
    for key, val in getattr(obj, "__dict__", {}).items():
        fields[key] = encode(val)
    return {"$c": name, "f": fields}


def _dec_ts(cls, v):
    return cls.unpack(v[0], v[1], v[2])


def _dec_keys(v):
    # verify the remote peer's ordering before trusting it: an
    # unsorted list silently corrupts bisect-based set operations
    ok = all(v[i] < v[i + 1] for i in range(len(v) - 1))
    return _Keys([_Key(t) for t in v], _presorted=ok)


def _dec_rkeys(v):
    ok = all(v[i] < v[i + 1] for i in range(len(v) - 1))
    return _RoutingKeys([_RoutingKey(t) for t in v], _presorted=ok)


def _dec_tuple(t):
    if all(type(x) is int for x in t):
        return tuple(t)
    return tuple(decode(x) for x in t)


_DEC1 = {
    "$T": lambda v: _dec_ts(_Timestamp, v),
    "$I": lambda v: _dec_ts(_TxnId, v),
    "$B": lambda v: _dec_ts(_Ballot, v),
    "$K": _Key,
    "$RK": _RoutingKey,
    "$Ks": _dec_keys,
    "$RKs": _dec_rkeys,
    "$t": _dec_tuple,
    "$s": lambda v: frozenset(decode(x) for x in v),
    "$d": lambda v: {decode(k): decode(val) for k, val in v},
}


def decode(data: Any) -> Any:
    t = type(data)
    if t is dict:
        if len(data) == 1:
            ((k, v),) = data.items()
            h = _DEC1.get(k)
            if h is not None:
                return h(v)
        return _decode_tagged(data)
    if t is list:
        return [decode(x) for x in data]
    return data  # scalars: None / bool / int / float / str


def _decode_tagged(data: dict) -> Any:
    if "$t" in data:
        return _dec_tuple(data["$t"])
    if "$s" in data:
        return frozenset(decode(x) for x in data["$s"])
    if "$d" in data:
        return {decode(k): decode(v) for k, v in data["$d"]}
    if "$e" in data:
        _registry()
        return _ENUMS[data["$e"]](decode(data["v"]))
    if "$x" in data:
        _registry()
        cls = _CLASSES.get(data["$x"])
        if cls is not None and issubclass(cls, BaseException):
            exc = cls(data["msg"])
            for key, val in (data.get("f") or {}).items():
                setattr(exc, key, decode(val))
            return exc
        return RuntimeError(f"{data['$x']}: {data['msg']}")
    name = data["$c"]
    cls = _registry().get(name)
    if cls is None:
        raise TypeError(f"unregistered wire type: {name}")
    obj = cls.__new__(cls)
    setattr_ = object.__setattr__
    dec = decode
    for key, val in data["f"].items():
        setattr_(obj, key, dec(val))
    return obj


def encode_message(msg) -> Any:
    """Top-level entry for Request/Reply payloads."""
    return encode(msg)


def decode_message(data) -> Any:
    return decode(data)


# ---------------------------------------------------- binary frame codec ----
#
# The TCP host's frames used to travel as JSON: every frame paid a full
# json.dumps/json.loads over the structural tree.  The binary codec below
# serialises the SAME tree (the output of `encode`, the input of `decode`)
# into a compact tagged format — one byte of tag per value, varints for
# ints, fast paths for the timestamp/key dicts that dominate deps-heavy
# payloads.  Two behaviourally identical implementations exist:
#
#   * this pure-Python tier (always available, the fallback), and
#   * native/_wire_codec.cpp (built lazily like _sorted_arrays.cpp),
#
# and they are BYTE-IDENTICAL by contract: tests/test_wire_roundtrip.py
# cross-checks pack outputs and unpack round-trips between the two over
# every registered verb, so a host running the native tier interoperates
# bit-for-bit with one running the fallback.  `unpack_frame` auto-detects
# legacy JSON frames (they start with "{"), so mixed-version peers and
# hand-written harness clients keep working.
#
# ACCORD_WIRE=json forces JSON frames (debugging); ACCORD_WIRE=py pins the
# Python tier (the codec A/B lever the bench and tests use).

import json as _json
import os as _os
import struct as _struct

WIRE_MAGIC = 0xAC    # cannot begin a JSON document
WIRE_VERSION = 0x01

_F64 = _struct.Struct(">d")
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

_T_NONE, _T_FALSE, _T_TRUE, _T_INT, _T_FLOAT = 0x00, 0x01, 0x02, 0x03, 0x04
_T_STR, _T_LIST, _T_DICT = 0x05, 0x06, 0x07
_T_TS, _T_TXNID, _T_BALLOT = 0x08, 0x09, 0x0A   # {"$T"/"$I"/"$B": [a,b,c]}
_T_KEY, _T_RKEY, _T_KEYS, _T_RKEYS = 0x0B, 0x0C, 0x0D, 0x0E  # token dicts
_T_ITUPLE = 0x0F                                 # {"$t": [int, ...]}
_T_BIGINT = 0x10                                 # decimal string (> int64)

_TAG1 = {"$T": _T_TS, "$I": _T_TXNID, "$B": _T_BALLOT,
         "$K": _T_KEY, "$RK": _T_RKEY,
         "$Ks": _T_KEYS, "$RKs": _T_RKEYS, "$t": _T_ITUPLE}
_KEY1 = {tag: key for key, tag in _TAG1.items()}


def _w_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _w_zigzag(out: bytearray, n: int) -> None:
    _w_varint(out, ((n << 1) ^ (n >> 63)) & 0xFFFFFFFFFFFFFFFF)


def _all_i64(xs) -> bool:
    for x in xs:
        if type(x) is not int or not (_I64_MIN <= x <= _I64_MAX):
            return False
    return True


_U64_MAX = (1 << 64) - 1


def _all_u64(xs) -> bool:
    # timestamp packs (msb/lsb/node) are non-negative bit-packs that can
    # exceed int64 (lsb carries hlc_low << 16): they travel as UNSIGNED
    # varints, where zigzag would overflow
    for x in xs:
        if type(x) is not int or not (0 <= x <= _U64_MAX):
            return False
    return True


def _py_pack_value(obj: Any, out: bytearray) -> None:
    t = type(obj)
    if obj is None:
        out.append(_T_NONE)
    elif t is bool:
        out.append(_T_TRUE if obj else _T_FALSE)
    elif t is int:
        if _I64_MIN <= obj <= _I64_MAX:
            out.append(_T_INT)
            _w_zigzag(out, obj)
        else:
            raw = str(obj).encode()
            out.append(_T_BIGINT)
            _w_varint(out, len(raw))
            out += raw
    elif t is float:
        out.append(_T_FLOAT)
        out += _F64.pack(obj)
    elif t is str:
        raw = obj.encode()
        out.append(_T_STR)
        _w_varint(out, len(raw))
        out += raw
    elif t is list or t is tuple:  # tuples flatten to lists, like JSON
        out.append(_T_LIST)
        _w_varint(out, len(obj))
        for x in obj:
            _py_pack_value(x, out)
    elif t is dict:
        if len(obj) == 1:
            ((k, v),) = obj.items()
            tag = _TAG1.get(k)
            # fast paths apply only to the exact shapes `encode` mints;
            # anything else (a host body reusing the key name) falls
            # through to the generic dict so nothing is misrepresented
            if tag is not None:
                if tag in (_T_TS, _T_TXNID, _T_BALLOT):
                    if type(v) is list and len(v) == 3 and _all_u64(v):
                        out.append(tag)
                        for x in v:
                            _w_varint(out, x)
                        return
                elif tag in (_T_KEY, _T_RKEY):
                    if type(v) is int and _I64_MIN <= v <= _I64_MAX:
                        out.append(tag)
                        _w_zigzag(out, v)
                        return
                elif type(v) is list and _all_i64(v):
                    out.append(tag)              # $Ks / $RKs / $t
                    _w_varint(out, len(v))
                    for x in v:
                        _w_zigzag(out, x)
                    return
        out.append(_T_DICT)
        _w_varint(out, len(obj))
        for k, v in obj.items():
            _py_pack_value(k, out)
            _py_pack_value(v, out)
    else:
        # a raw protocol object at the payload boundary: the structural
        # walk (encode) yields its tree, packed with tree semantics —
        # the byte-identical Python mirror of the native one-pass object
        # packer (unregistered types raise from encode, as ever)
        _py_pack_value(encode(obj), out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data, pos: int = 0):
        self.data = data
        self.pos = pos

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated binary frame")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def varint(self) -> int:
        shift = 0
        v = 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 70:
                raise ValueError("varint too long")

    def zigzag(self) -> int:
        u = self.varint()
        return (u >> 1) ^ -(u & 1)


def _py_unpack_value(r: _Reader) -> Any:
    tag = r.byte()
    if tag == _T_NONE:
        return None
    if tag == _T_FALSE:
        return False
    if tag == _T_TRUE:
        return True
    if tag == _T_INT:
        return r.zigzag()
    if tag == _T_FLOAT:
        return _F64.unpack(r.take(8))[0]
    if tag == _T_STR:
        return r.take(r.varint()).decode()
    if tag == _T_LIST:
        return [_py_unpack_value(r) for _ in range(r.varint())]
    if tag == _T_DICT:
        out = {}
        for _ in range(r.varint()):
            k = _py_unpack_value(r)
            out[k] = _py_unpack_value(r)
        return out
    if tag in (_T_TS, _T_TXNID, _T_BALLOT):
        return {_KEY1[tag]: [r.varint(), r.varint(), r.varint()]}
    if tag in (_T_KEY, _T_RKEY):
        return {_KEY1[tag]: r.zigzag()}
    if tag in (_T_KEYS, _T_RKEYS, _T_ITUPLE):
        return {_KEY1[tag]: [r.zigzag() for _ in range(r.varint())]}
    if tag == _T_BIGINT:
        return int(r.take(r.varint()).decode())
    raise ValueError(f"unknown binary wire tag 0x{tag:02x}")


def py_pack(obj: Any) -> bytes:
    """Pure-Python pack of one encoded tree (no frame header)."""
    out = bytearray()
    _py_pack_value(obj, out)
    return bytes(out)


def py_unpack(data: bytes) -> Any:
    """Pure-Python unpack of one packed tree (no frame header)."""
    r = _Reader(data)
    out = _py_unpack_value(r)
    if r.pos != len(data):
        raise ValueError("trailing bytes after binary frame")
    return out


def _native_codec():
    """(pack, unpack) from the native tier, or None (build failure, no
    toolchain, ACCORD_NO_NATIVE=1).  Binding arms the native raw-object
    packer: the primitive classes, enum base, the (lazy) verb registry and
    slots helper, and the Python `encode` as its semantics-of-last-resort
    fallback."""
    from accord_tpu_torch import native
    mod = native.get_wire()
    if mod is None:
        return None
    def _provider():
        _registry()
        return _CLASSES, _ENUMS

    mod.wire_bind(_Timestamp, _TxnId, _Ballot, _Key, _RoutingKey, _Keys,
                  _RoutingKeys, enum.Enum, _provider, _slots_of, encode)
    return mod.wire_pack, mod.wire_unpack, mod.wire_unpack_obj


_WIRE_MODE = _os.environ.get("ACCORD_WIRE", "")
if _WIRE_MODE == "py":
    _NATIVE = None
else:
    try:
        _NATIVE = _native_codec()
    except Exception:  # noqa: BLE001 — any native failure means Python tier
        _NATIVE = None

_HEADER = bytes((WIRE_MAGIC, WIRE_VERSION))


def codec_tier() -> str:
    """Which frame codec this process runs: native / python / json."""
    if _WIRE_MODE == "json":
        return "json"
    return "native" if _NATIVE is not None else "python"


def packs_objects() -> bool:
    """Both binary tiers serialise RAW protocol objects at the payload
    boundary in one pass (tree-free); only the legacy JSON mode needs the
    sender to pre-encode payload trees."""
    return _WIRE_MODE != "json"


def pack_frame(obj: Any) -> bytes:
    """One wire frame body: binary (native tier when available) unless
    ACCORD_WIRE=json pins the legacy JSON framing."""
    if _WIRE_MODE == "json":
        return _json.dumps(obj).encode()
    if _NATIVE is not None:
        return _HEADER + _NATIVE[0](obj)
    return _HEADER + py_pack(obj)


def unpack_frame(data: bytes) -> Any:
    """Decode one frame body to its TREE, auto-detecting the format:
    binary frames start with the magic byte, JSON frames with '{' (legacy
    peers, hand-written harness clients)."""
    if data[:1] == _HEADER[:1]:
        if data[1] != WIRE_VERSION:
            raise ValueError(f"unknown binary wire version {data[1]}")
        if _NATIVE is not None:
            return _NATIVE[1](bytes(data[2:]))
        return py_unpack(data[2:])
    return _json.loads(data.decode())


def unpack_frame_obj(data: bytes) -> Any:
    """Decode one frame body with payloads as DECODED MESSAGE OBJECTS —
    the native fusion of unpack_frame + decode_message (one pass, no
    intermediate tree).  Falls back to the tree form when the native tier
    is absent: callers must decode dict-typed payloads themselves (the
    `decode_message(p) if type(p) is dict else p` pattern)."""
    if data[:1] == _HEADER[:1] and _NATIVE is not None:
        if data[1] != WIRE_VERSION:
            raise ValueError(f"unknown binary wire version {data[1]}")
        return _NATIVE[2](bytes(data[2:]))
    return unpack_frame(data)
