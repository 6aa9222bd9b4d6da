"""Callback-based async primitives (reference: accord/utils/async/AsyncChain.java:29,
AsyncChains.java, AsyncResult).

Deliberately NOT asyncio: the deterministic simulator (accord_tpu_torch.sim) must own
every scheduling decision, so these are plain callback chains with no event loop
of their own. Callbacks fire synchronously on settle (on the settler's thread /
simulated executor), matching the reference's semantics.
"""

from __future__ import annotations

import traceback
from typing import Callable, Generic, List, Optional, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class AsyncResult(Generic[T]):
    """Settable result with (value, failure) callbacks. Settles exactly once."""

    __slots__ = ("_done", "_value", "_failure", "_callbacks")

    def __init__(self):
        self._done = False
        self._value: Optional[T] = None
        self._failure: Optional[BaseException] = None
        self._callbacks: List[Callable] = []

    # -- settling --
    def set_success(self, value: T = None) -> "AsyncResult[T]":
        return self._settle(value, None)

    def set_failure(self, failure: BaseException) -> "AsyncResult[T]":
        return self._settle(None, failure)

    def try_success(self, value: T = None) -> bool:
        if self._done:
            return False
        self._settle(value, None)
        return True

    def try_failure(self, failure: BaseException) -> bool:
        if self._done:
            return False
        self._settle(None, failure)
        return True

    def _settle(self, value, failure) -> "AsyncResult[T]":
        if self._done:
            raise RuntimeError("result already settled")
        self._done = True
        self._value = value
        self._failure = failure
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(value, failure)
        return self

    # -- observation --
    @property
    def is_done(self) -> bool:
        return self._done

    @property
    def is_success(self) -> bool:
        return self._done and self._failure is None

    def value(self) -> T:
        if not self._done:
            raise RuntimeError("not settled")
        if self._failure is not None:
            raise self._failure
        return self._value

    def failure(self) -> Optional[BaseException]:
        return self._failure

    def add_callback(self, cb: Callable[[Optional[T], Optional[BaseException]], None]
                     ) -> "AsyncResult[T]":
        """cb(value, failure); fires immediately if already settled."""
        if self._done:
            cb(self._value, self._failure)
        else:
            self._callbacks.append(cb)
        return self

    def on_success(self, fn: Callable[[T], None]) -> "AsyncResult[T]":
        return self.add_callback(lambda v, f: fn(v) if f is None else None)

    def on_failure(self, fn: Callable[[BaseException], None]) -> "AsyncResult[T]":
        return self.add_callback(lambda v, f: fn(f) if f is not None else None)

    # -- composition --
    def map(self, fn: Callable[[T], U]) -> "AsyncResult[U]":
        out: AsyncResult[U] = AsyncResult()

        def cb(v, f):
            if f is not None:
                out.set_failure(f)
            else:
                try:
                    out.set_success(fn(v))
                except BaseException as e:  # noqa: BLE001 - chain must carry it
                    out.set_failure(e)

        self.add_callback(cb)
        return out

    def flat_map(self, fn: Callable[[T], "AsyncResult[U]"]) -> "AsyncResult[U]":
        out: AsyncResult[U] = AsyncResult()

        def cb(v, f):
            if f is not None:
                out.set_failure(f)
            else:
                try:
                    fn(v).add_callback(lambda v2, f2: out._settle(v2, f2))
                except BaseException as e:  # noqa: BLE001
                    out.set_failure(e)

        self.add_callback(cb)
        return out

    def recover(self, fn: Callable[[BaseException], T]) -> "AsyncResult[T]":
        out: AsyncResult[T] = AsyncResult()

        def cb(v, f):
            if f is None:
                out.set_success(v)
            else:
                try:
                    out.set_success(fn(f))
                except BaseException as e:  # noqa: BLE001
                    out.set_failure(e)

        self.add_callback(cb)
        return out

    def begin(self, agent_on_failure: Callable[[BaseException], None]) -> None:
        """Terminal subscription: route failures to the agent (reference
        AsyncChain.begin(Agent))."""
        self.add_callback(lambda v, f: agent_on_failure(f) if f is not None else None)


def success(value: T = None) -> AsyncResult[T]:
    return AsyncResult().set_success(value)


def failure(err: BaseException) -> AsyncResult:
    return AsyncResult().set_failure(err)


def all_of(results: Sequence[AsyncResult]) -> AsyncResult[list]:
    """Settles with the list of values, or the first failure (reference
    AsyncChains.all / reduce)."""
    out: AsyncResult[list] = AsyncResult()
    n = len(results)
    if n == 0:
        return out.set_success([])
    values = [None] * n
    remaining = [n]

    def make_cb(i):
        def cb(v, f):
            if out.is_done:
                return
            if f is not None:
                out.try_failure(f)
                return
            values[i] = v
            remaining[0] -= 1
            if remaining[0] == 0:
                out.try_success(values)
        return cb

    for i, r in enumerate(results):
        r.add_callback(make_cb(i))
    return out


def reduce(results: Sequence[AsyncResult], fn: Callable[[T, T], T]) -> AsyncResult[T]:
    def combine(values: list):
        acc = values[0]
        for v in values[1:]:
            acc = fn(acc, v)
        return acc
    return all_of(results).map(combine)


def format_failure(f: BaseException) -> str:
    return "".join(traceback.format_exception(type(f), f, f.__traceback__))
