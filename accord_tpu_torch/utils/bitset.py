"""Bitsets backing the WaitingOn execution-order state.

Reference: accord/utils/SimpleBitSet.java:27 / ImmutableBitSet. Python ints are
arbitrary-precision, so a single int is the natural (and fast) representation;
the device tier re-expresses these as packed uint32 lanes (accord_tpu_torch.ops).
"""

from __future__ import annotations

from typing import Iterator


class SimpleBitSet:
    __slots__ = ("_bits", "_size")

    def __init__(self, size: int, bits: int = 0):
        self._size = size
        self._bits = bits

    @classmethod
    def full(cls, size: int) -> "SimpleBitSet":
        return cls(size, (1 << size) - 1)

    def set(self, i: int) -> bool:
        """Set bit i; returns True if it was previously unset."""
        mask = 1 << i
        was = self._bits & mask
        self._bits |= mask
        return not was

    def unset(self, i: int) -> bool:
        mask = 1 << i
        was = self._bits & mask
        self._bits &= ~mask
        return bool(was)

    def get(self, i: int) -> bool:
        return bool((self._bits >> i) & 1)

    def count(self) -> int:
        return bin(self._bits).count("1")

    def is_empty(self) -> bool:
        return self._bits == 0

    def first_set(self) -> int:
        """Lowest set bit index, or -1."""
        if self._bits == 0:
            return -1
        return (self._bits & -self._bits).bit_length() - 1

    def last_set(self) -> int:
        if self._bits == 0:
            return -1
        return self._bits.bit_length() - 1

    def next_set(self, from_idx: int) -> int:
        """Lowest set bit >= from_idx, or -1."""
        shifted = self._bits >> from_idx
        if shifted == 0:
            return -1
        return from_idx + (shifted & -shifted).bit_length() - 1

    def prev_set(self, from_idx: int) -> int:
        """Highest set bit <= from_idx, or -1."""
        masked = self._bits & ((1 << (from_idx + 1)) - 1)
        if masked == 0:
            return -1
        return masked.bit_length() - 1

    def __iter__(self) -> Iterator[int]:
        bits = self._bits
        while bits:
            low = bits & -bits
            yield low.bit_length() - 1
            bits ^= low

    def __len__(self) -> int:
        return self._size

    def __eq__(self, other) -> bool:
        return isinstance(other, SimpleBitSet) and self._bits == other._bits

    def __hash__(self):
        return hash(self._bits)

    def __repr__(self) -> str:
        return f"BitSet({sorted(self)}/{self._size})"

    def raw(self) -> int:
        return self._bits

    def copy(self) -> "SimpleBitSet":
        return SimpleBitSet(self._size, self._bits)


class ImmutableBitSet(SimpleBitSet):
    """Frozen view; mutators raise (reference ImmutableBitSet)."""

    def set(self, i: int) -> bool:  # pragma: no cover - guard
        raise TypeError("immutable bitset")

    def unset(self, i: int) -> bool:  # pragma: no cover - guard
        raise TypeError("immutable bitset")

    def mutable(self) -> SimpleBitSet:
        return SimpleBitSet(self._size, self._bits)
