"""Bounded multi-producer multi-consumer channel with batched reads
(counterpart of ``paddlebox_tpu/data/channel.py``, itself the
reference system's ``framework::Channel``): a capacity-bounded queue
whose readers pop blocks of items, with an explicit close so consumers
drain and exit.

Failure propagation: producers register (``add_producer`` and
``producer_done``, or the ``producing()`` context manager), so the
channel knows work is in flight. A producer that dies calls
``fail(exc)``: the channel is poisoned, items already queued stay
consumable, and a consumer that would otherwise wait forever re-raises
the producer's original error after that prefix. While producers are
registered, a ``get_many`` timeout raises :class:`ChannelTimeout` rather
than returning the ``[]`` that means closed and drained.

The staged device feed (``data/device_feed.py``) hands its chunks to the
training thread through one. Counts ``ingest.channel_failures``,
``ingest.channel_timeouts`` and the ``ingest.channel_wait_ms`` histogram
in the global registry, as the reference does. Imports no torch.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Generic, Iterable, List, Optional, TypeVar

from paddlebox_tpu_torch.obs.metrics import REGISTRY

T = TypeVar("T")


class ChannelTimeout(TimeoutError):
    """``get_many`` timed out while registered producers were still live —
    the stream stalled; it did NOT end."""


class Channel(Generic[T]):
    def __init__(self, capacity: int = 0, block_size: int = 1024):
        self._capacity = capacity  # 0 = unbounded
        self._block_size = block_size
        self._items: Deque[T] = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._producers = 0
        self._exc: Optional[BaseException] = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def closed_and_drained(self) -> bool:
        """True iff consumers are done: closed AND nothing left to pop —
        distinguishable from a ``get_many`` timeout on a live channel."""
        with self._lock:
            return self._closed and not self._items

    @property
    def failed(self) -> Optional[BaseException]:
        """The poisoning error, if a producer failed."""
        with self._lock:
            return self._exc

    # -- producer lifecycle --------------------------------------------------

    def add_producer(self, n: int = 1) -> None:
        """Register ``n`` producers.  While any are registered, consumers
        treat a read timeout as a stall (raise) rather than end-of-stream."""
        with self._lock:
            self._producers += n

    def producer_done(self) -> None:
        """One producer finished cleanly.  The LAST one out closes the
        channel, so consumers drain and exit without an explicit close."""
        with self._lock:
            if self._producers <= 0:
                raise RuntimeError("producer_done without add_producer")
            self._producers -= 1
            if self._producers == 0 and not self._closed:
                self._closed = True
                self._not_empty.notify_all()
                self._not_full.notify_all()

    def fail(self, exc: BaseException) -> None:
        """Poison the channel: a producer died with ``exc``.  Queued items
        stay consumable; once drained (or immediately, for consumers
        blocked on an empty channel) ``get_many`` re-raises ``exc``.
        First failure wins; producers blocked in ``put_many`` unblock.

        The registration count is left alone — ``fail`` may come from an
        unregistered caller (a watchdog, a consumer), and consuming a
        slot would make a HEALTHY producer's later ``producer_done``
        raise.  Once poisoned the channel is closed, so the count no
        longer gates anything."""
        with self._lock:
            if self._exc is None:
                self._exc = exc
                # how often feed channels are poisoned by dead
                # producers, apart from consumer-side timeouts
                REGISTRY.add("ingest.channel_failures")
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @contextmanager
    def producing(self):
        """``with ch.producing(): ...`` — registers a producer; a clean
        exit is ``producer_done()`` (last one closes), an exception calls
        ``fail(exc)`` so consumers see the original error instead of a
        stranded channel."""
        self.add_producer()
        try:
            yield self
        except BaseException as e:
            self.fail(e)
            raise
        else:
            self.producer_done()

    # -- data path -----------------------------------------------------------

    def put(self, item: T) -> None:
        self.put_many((item,))

    def put_many(self, items: Iterable[T]) -> None:
        items = list(items)
        i = 0
        with self._not_full:
            while i < len(items):
                if self._exc is not None:
                    raise RuntimeError(
                        "put on failed channel") from self._exc
                if self._closed:
                    raise RuntimeError("put on closed channel")
                if self._capacity and len(self._items) >= self._capacity:
                    self._not_full.wait()
                    continue
                budget = (self._capacity - len(self._items)
                          if self._capacity else len(items) - i)
                take = items[i:i + max(1, budget)]
                self._items.extend(take)
                i += len(take)
                self._not_empty.notify_all()

    def get(self, timeout: Optional[float] = None) -> Optional[T]:
        block = self.get_many(1, timeout=timeout)
        return block[0] if block else None

    def get_many(self, n: int = 0, timeout: Optional[float] = None) -> List[T]:
        """Pop up to ``n`` items (default: block_size).

        Returns ``[]`` only when the channel is closed and drained, or on
        timeout with NO registered producers (legacy semantics).  A
        timeout while producers are registered raises
        :class:`ChannelTimeout`; a failed channel raises the producer's
        original error once queued items are drained."""
        n = n or self._block_size
        waited = 0.0
        try:
            with self._not_empty:
                while not self._items and not self._closed:
                    t0 = time.perf_counter()
                    got = self._not_empty.wait(timeout=timeout)
                    waited += time.perf_counter() - t0
                    if not got:
                        if self._items or self._closed:
                            break      # raced with a late put/close
                        if self._producers > 0:
                            REGISTRY.add("ingest.channel_timeouts")
                            raise ChannelTimeout(
                                f"no items within {timeout:g}s but "
                                f"{self._producers} producer(s) still "
                                f"registered")
                        return []
                if not self._items and self._exc is not None:
                    raise self._exc
                out = []
                while self._items and len(out) < n:
                    out.append(self._items.popleft())
                if out:
                    self._not_full.notify_all()
                return out
        finally:
            # consumer-starvation signal, recorded OUTSIDE the channel
            # lock, only when the pop actually blocked, and on EVERY exit
            # — the timeout raise is the worst wait and must not be the
            # one the histogram misses
            if waited > 0.0:
                REGISTRY.observe("ingest.channel_wait_ms", waited * 1e3)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def reopen(self) -> None:
        with self._lock:
            self._closed = False
            self._exc = None
            self._producers = 0

    def drain(self) -> List[T]:
        """Everything until closed-and-drained.  On a failed channel the
        queued prefix is popped first, then the producer's error raises —
        a consumer never mistakes a truncated stream for a complete one."""
        out: List[T] = []
        while True:
            block = self.get_many(self._block_size)
            if not block:
                return out
            out.extend(block)