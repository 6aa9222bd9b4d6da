"""Property-testing layer: seeded generator combinators + shrinking forAll.

Reference: accord-core test utils/Property.java:38 (forAll builders with
seed/example reporting) and Gens.java:45 (generator combinators over
RandomSource — pick, oneOf, zipf, lists). Ours keeps the same shape over
accord_tpu_torch.utils.random_source.RandomSource and adds greedy value-level
shrinking (the reference reports the failing seed only): primitive
generators carry shrinkers (ints bisect toward a floor, lists drop chunks
then shrink elements), and a failing example is minimised within a bounded
budget before reporting.

    from accord_tpu_torch.utils.property import Gens, for_all
    for_all(Gens.lists(Gens.ints(0, 100)), examples=200, seed=1)(
        lambda xs: check(xs))
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Sequence

from accord_tpu_torch.utils.random_source import RandomSource


class PropertyError(AssertionError):
    pass


class Gen:
    """A seeded generator: rng -> value, with an optional shrinker
    (value -> candidate smaller values, best candidates first)."""

    __slots__ = ("fn", "shrinker")

    def __init__(self, fn: Callable[[RandomSource], Any],
                 shrinker: Optional[Callable[[Any], Iterable]] = None):
        self.fn = fn
        self.shrinker = shrinker

    def __call__(self, rng: RandomSource):
        return self.fn(rng)

    def shrink(self, value) -> Iterable:
        if self.shrinker is None:
            return ()
        return self.shrinker(value)

    def map(self, f: Callable) -> "Gen":
        """NOTE: mapping loses shrinking (the inverse is unknown); pass an
        explicit shrinker via with_shrinker if minimisation matters."""
        return Gen(lambda rng: f(self.fn(rng)))

    def filter(self, pred: Callable[[Any], bool], retries: int = 100
               ) -> "Gen":
        def gen(rng):
            for _ in range(retries):
                v = self.fn(rng)
                if pred(v):
                    return v
            raise PropertyError(f"filter exhausted {retries} retries")

        def shrinker(value):
            return (v for v in self.shrink(value) if pred(v))

        return Gen(gen, shrinker if self.shrinker is not None else None)

    def flat_map(self, f: Callable[[Any], "Gen"]) -> "Gen":
        return Gen(lambda rng: f(self.fn(rng))(rng))

    def with_shrinker(self, shrinker: Callable[[Any], Iterable]) -> "Gen":
        return Gen(self.fn, shrinker)


def _shrink_int_toward(lo: int):
    def shrinker(v: int):
        if v == lo:
            return
        yield lo
        cur = v
        while abs(cur - lo) > 1:
            cur = lo + (cur - lo) // 2
            yield cur
        yield v - 1 if v > lo else v + 1
    return shrinker


def _shrink_list(elem: Gen, min_size: int = 0):
    def shrinker(xs: Sequence):
        xs = list(xs)
        n = len(xs)
        if n == 0:
            return
        # never leave the generator's domain: every candidate keeps min_size
        if min_size == 0:
            yield []
        elif n > min_size:
            yield xs[:min_size]
        # drop halves, then single elements
        if n > 1:
            if n // 2 >= min_size:
                yield xs[:n // 2]
            if n - n // 2 >= min_size:
                yield xs[n // 2:]
        if n - 1 >= min_size:
            for i in range(n):
                yield xs[:i] + xs[i + 1:]
        # shrink elements pointwise
        for i in range(n):
            for smaller in elem.shrink(xs[i]):
                yield xs[:i] + [smaller] + xs[i + 1:]
    return shrinker


class Gens:
    """Generator combinators (Gens.java)."""

    @staticmethod
    def constant(v) -> Gen:
        return Gen(lambda rng: v)

    @staticmethod
    def ints(lo: int, hi: int) -> Gen:
        """Uniform int in [lo, hi)."""
        return Gen(lambda rng: rng.next_int(lo, hi),
                   _shrink_int_toward(lo))

    @staticmethod
    def bools(true_prob: float = 0.5) -> Gen:
        return Gen(lambda rng: rng.next_float() < true_prob,
                   lambda v: (False,) if v else ())

    @staticmethod
    def pick(items: Sequence) -> Gen:
        items = list(items)
        return Gen(lambda rng: items[rng.next_int(len(items))],
                   lambda v: (x for x in items[:items.index(v)]))

    @staticmethod
    def one_of(*gens: Gen) -> Gen:
        return Gen(lambda rng: gens[rng.next_int(len(gens))](rng))

    @staticmethod
    def zipf(n: int, alpha: float = 0.99) -> Gen:
        """Zipf-distributed index in [0, n) (Gens.pickZipf)."""
        return Gen(lambda rng: rng.next_zipf(n, alpha),
                   _shrink_int_toward(0))

    @staticmethod
    def lists(elem: Gen, min_size: int = 0, max_size: int = 16) -> Gen:
        def gen(rng):
            n = rng.next_int(min_size, max_size + 1)
            return [elem(rng) for _ in range(n)]
        return Gen(gen, _shrink_list(elem, min_size))

    @staticmethod
    def tuples(*gens: Gen) -> Gen:
        def gen(rng):
            return tuple(g(rng) for g in gens)

        def shrinker(value):
            for i, g in enumerate(gens):
                for smaller in g.shrink(value[i]):
                    yield value[:i] + (smaller,) + value[i + 1:]
        return Gen(gen, shrinker)

    @staticmethod
    def random_source() -> Gen:
        """A forked RandomSource, for properties that drive their own
        randomness (Gens.random)."""
        return Gen(lambda rng: rng.fork())


def for_all(*gens: Gen, examples: int = 100, seed: int = 0,
            shrink_budget: int = 300):
    """Run `prop(*values)` over seeded examples; on failure, greedily shrink
    each argument within `shrink_budget` re-runs and raise PropertyError
    naming the seed, example index, and the minimal counterexample found.

        for_all(gen_a, gen_b, examples=200)(prop)
    """

    def runner(prop: Callable):
        for example in range(examples):
            rng = RandomSource(seed * 1_000_003 + example)
            values = [g(rng) for g in gens]
            try:
                prop(*values)
            except Exception as original:  # noqa: BLE001
                shrunk, attempts = _shrink(gens, values, prop, shrink_budget)
                raise PropertyError(
                    f"property failed (seed={seed}, example={example}, "
                    f"shrink_attempts={attempts}):\n"
                    f"  original: {values!r}\n"
                    f"  minimal:  {shrunk!r}\n"
                    f"  failure:  {original!r}") from original
        return prop

    return runner


def _fails(prop, values) -> bool:
    try:
        prop(*values)
        return False
    except Exception:  # noqa: BLE001
        return True


def _shrink(gens, values: List, prop, budget: int):
    values = list(values)
    attempts = 0
    improved = True
    while improved and attempts < budget:
        improved = False
        for i, g in enumerate(gens):
            for candidate in g.shrink(values[i]):
                if attempts >= budget:
                    break
                attempts += 1
                trial = values[:i] + [candidate] + values[i + 1:]
                if _fails(prop, trial):
                    values = trial
                    improved = True
                    break
    return values, attempts
