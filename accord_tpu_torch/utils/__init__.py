"""Foundation utilities (reference: accord/utils — SURVEY.md §2.8).

Sorted-array kernels, CSR multimap helpers, bitsets, deterministic randomness,
interval maps, async chains, and the invariant/assertion layer.
"""

from accord_tpu_torch.utils.invariants import (
    check, check_state, check_argument, non_null, Paranoia, illegal_state,
)
from accord_tpu_torch.utils.sorted_arrays import (
    linear_union, linear_intersection, linear_subtract, binary_search,
    exponential_search, Search, is_sorted_unique, next_intersection,
)
from accord_tpu_torch.utils.bitset import SimpleBitSet, ImmutableBitSet
from accord_tpu_torch.utils.random_source import RandomSource, DefaultRandom
from accord_tpu_torch.utils.interval_map import ReducingIntervalMap, ReducingRangeMap
