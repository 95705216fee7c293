"""Port's ``data/channel.py`` ``Channel`` against the JAX package's on the
same seeded sequences of operations: each operation's result, or its
exception's type and message, equal, step by step; and a producer thread
that fails mid-stream behind ``producing()``, whose consumer gets the
same prefix and then the original error in both. The port's registry
counts what the reference's counts."""

import threading

import numpy as np
import pytest

from paddlebox_tpu.data.channel import Channel as JaxChannel
from paddlebox_tpu.data.channel import ChannelTimeout as JaxTimeout
from paddlebox_tpu_torch.data.channel import Channel, ChannelTimeout
from paddlebox_tpu_torch.obs.metrics import REGISTRY

TIMEOUT = 0.001


def run_ops(ch, ops):
    """Apply ``ops`` to ``ch``; returns each one's outcome: its result,
    or (exception class name, message)."""
    out = []
    for op, arg in ops:
        try:
            if op == "put_many":
                res = ch.put_many(arg)
            elif op == "get_many":
                res = ch.get_many(arg, timeout=TIMEOUT)
            elif op == "get":
                res = ch.get(timeout=TIMEOUT)
            elif op == "fail":
                res = ch.fail(RuntimeError(arg))
            elif op == "drain":
                res = ch.drain()
            elif op == "state":
                res = (len(ch), ch.closed, ch.closed_and_drained,
                       None if ch.failed is None else str(ch.failed))
            else:
                res = getattr(ch, op)()
            out.append(("ok", res))
        except Exception as e:  # noqa: BLE001 - the outcome compared
            name = type(e).__name__
            if isinstance(e, (ChannelTimeout, JaxTimeout)):
                name = "ChannelTimeout"
            out.append((name, str(e)))
    return out


def seeded_ops(seed, capacity, n=120):
    """A sequence that never blocks one thread: puts only into room,
    drains only once closed."""
    rng = np.random.default_rng(seed)
    ops, held, producers, closed, item = [], 0, 0, False, 0
    for i in range(n):
        choice = rng.integers(0, 10)
        if choice < 3 and not closed:
            room = capacity - held if capacity else 5
            k = int(rng.integers(1, max(room, 1) + 1))
            if room > 0:
                ops.append(("put_many", list(range(item, item + k))))
                item += k
                held += k
        elif choice < 5:
            k = int(rng.integers(1, 4))
            ops.append(("get_many", k))
            held = max(0, held - k)
        elif choice == 5:
            ops.append(("get", None))
            held = max(0, held - 1)
        elif choice == 6 and not closed:
            ops.append(("add_producer", None))
            producers += 1
        elif choice == 7 and producers:
            ops.append(("producer_done", None))
            producers -= 1
            closed = closed or producers == 0
        elif choice == 8 and rng.random() < 0.2:
            ops.append(("fail", f"producer {i} died"))
            closed = True
        elif choice == 9 and rng.random() < 0.2:
            ops.append(("close", None))
            closed = True
        ops.append(("state", None))
    if closed:
        ops.append(("drain", None))
    ops += [("put_many", [-1]), ("producer_done", None), ("reopen", None),
            ("put_many", [7, 8]), ("close", None),
            ("drain", None)] if closed else []
    return ops


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("capacity", [0, 4])
def test_seeded_sequences_match_reference(seed, capacity):
    ops = seeded_ops(seed, capacity)
    got = run_ops(Channel(capacity=capacity, block_size=3), ops)
    want = run_ops(JaxChannel(capacity=capacity, block_size=3), ops)
    assert got == want


def _produce_then_fail(ch, items, exc):
    try:
        with ch.producing():
            for x in items:
                ch.put(x)
            raise exc
    except ValueError:
        pass          # producing() poisoned the channel with it


@pytest.mark.parametrize("cls", [Channel, JaxChannel])
def test_failed_producer_raises_after_its_prefix(cls):
    """A producer thread dies after 10 items behind ``producing()``: the
    consumer's ``drain`` pops the 10, then raises the original error (the
    same object), as in the reference; a put after it raises."""
    ch = cls(capacity=3)
    exc = ValueError("parse failed at row 7")
    th = threading.Thread(target=_produce_then_fail,
                          args=(ch, range(10), exc))
    got = []
    before = REGISTRY.counter("ingest.channel_failures").get()
    th.start()
    with pytest.raises(ValueError) as info:
        while True:
            block = ch.get_many(4, timeout=5)
            if not block:
                break
            got.extend(block)
    th.join()
    assert info.value is exc and got == list(range(10))
    assert ch.failed is exc and ch.closed_and_drained
    with pytest.raises(RuntimeError, match="put on failed channel"):
        ch.put(1)
    if cls is Channel:
        assert REGISTRY.counter("ingest.channel_failures").get() == \
            before + 1


def test_timeout_with_live_producer_is_a_stall():
    for cls, timeout_cls in ((Channel, ChannelTimeout),
                             (JaxChannel, JaxTimeout)):
        ch = cls()
        ch.add_producer()
        with pytest.raises(timeout_cls, match="1 producer"):
            ch.get_many(1, timeout=TIMEOUT)
        ch.producer_done()
        assert ch.get_many(1, timeout=TIMEOUT) == []
