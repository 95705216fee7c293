"""Typed metrics: counters, gauges and lock-striped log-bucket histograms
(counterpart of ``paddlebox_tpu/obs/metrics.py``).

- :class:`Counter`: a monotonic value (``add``; ``set`` for the legacy
  ``StatValue`` surface).
- :class:`Gauge`: a point-in-time float (``set``/``add``): queue depths,
  buffers in flight, the last pass's AUC.
- :class:`Histogram`: a latency or size distribution over 256 fixed
  log-spaced buckets (a percentile estimate within ~7% of the true
  value), striped over 8 locks by thread id so that the trainer, the feed
  producer and the parse threads never contend on one lock.

One process-global :data:`REGISTRY` serves every subsystem
(``utils/monitor.py``'s ``STATS`` is the same object). ``snapshot()``
flattens it to scalars, a histogram as ``<name>.count/.sum/.p50/.p95/
.p99/.max``, and :func:`delta` subtracts two snapshots for a per-pass
view. The bucket geometry, ``bucket_index``, ``bucket_bound`` and
``percentile_from_counts`` are the reference's, so both registries give
the same percentiles from the same observations.

Imports neither torch nor numpy: the data feed's parse workers import it.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Tuple, Union

Number = Union[int, float]

# log-bucket geometry shared by every histogram: bounds[i] = LO * G**i.
# 256 buckets spanning [1e-6, ~1e9) => G = 10**(15/256) ~ 1.144: any
# recorded value maps to a bucket whose bounds differ by <15%, so a
# midpoint percentile estimate is within ~7% of the true value.
_NBUCKETS = 256
_LO = 1e-6
_G = 10.0 ** (15.0 / _NBUCKETS)
_LOG_G = math.log(_G)
_LOG_LO = math.log(_LO)
_NSTRIPES = 8


class Counter:
    """Monotonic counter (StatValue compatible: add/set/get)."""

    __slots__ = ("_value", "_lock")
    kind = "counter"

    def __init__(self):
        self._value = 0              # guarded-by: _lock
        self._lock = threading.Lock()

    def add(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, n: Number) -> None:
        with self._lock:
            self._value = n

    def get(self) -> Number:
        with self._lock:
            return self._value

    # StatValue exposed ``.value`` as a plain attribute
    @property
    def value(self) -> Number:
        return self.get()


class Gauge:
    """Point-in-time value: last ``set`` (or accumulated ``add``) wins."""

    __slots__ = ("_value", "_lock")
    kind = "gauge"

    def __init__(self):
        self._value = 0.0            # guarded-by: _lock
        self._lock = threading.Lock()

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: Number) -> None:
        with self._lock:
            self._value += float(dv)

    def get(self) -> float:
        with self._lock:
            return self._value


class _Stripe:
    __slots__ = ("lock", "counts", "total", "n", "vmax")

    def __init__(self):
        self.lock = threading.Lock()
        self.counts = [0] * _NBUCKETS   # guarded-by: lock
        self.total = 0.0                # guarded-by: lock
        self.n = 0                      # guarded-by: lock
        self.vmax = 0.0                 # guarded-by: lock


def bucket_index(v: float) -> int:
    """Bucket of ``v`` under the shared log geometry (clamped)."""
    if v <= _LO:
        return 0
    i = int((math.log(v) - _LOG_LO) / _LOG_G) + 1
    return i if i < _NBUCKETS else _NBUCKETS - 1


def bucket_bound(i: int) -> float:
    """Upper bound of bucket ``i`` (inclusive)."""
    return _LO * _G ** i


def percentile_from_counts(counts: List[int], n: int, vmax: float,
                           q: float) -> float:
    """q-quantile estimate from raw bucket counts under the shared log
    geometry — the primitive both a histogram's cumulative view and a
    WINDOWED view (two ``state()`` snapshots diffed) share."""
    if n == 0:
        return 0.0
    rank = q * n
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank and c:
            if i == 0:
                return _LO
            mid = _LO * _G ** (i - 0.5)   # geometric bucket midpoint
            return min(mid, vmax) if vmax else mid
    return vmax


class Histogram:
    """Fixed log-bucket histogram with per-stripe locks.

    ``observe`` touches only the caller's stripe (keyed by thread id), so
    trainer / ingest / ckpt / serving threads record concurrently without
    sharing a lock; reads merge the stripes."""

    __slots__ = ("_stripes",)
    kind = "histogram"

    def __init__(self):
        self._stripes = tuple(_Stripe() for _ in range(_NSTRIPES))

    def observe(self, v: Number) -> None:
        v = float(v)
        if v < 0.0 or v != v:        # negative/NaN: never a real latency
            return
        s = self._stripes[threading.get_ident() % _NSTRIPES]
        i = bucket_index(v)
        with s.lock:
            s.counts[i] += 1
            s.total += v
            s.n += 1
            if v > s.vmax:
                s.vmax = v

    def _merged(self) -> Tuple[List[int], float, int, float]:
        counts = [0] * _NBUCKETS
        total = 0.0
        n = 0
        vmax = 0.0
        for s in self._stripes:
            with s.lock:
                sc = list(s.counts)
                total += s.total
                n += s.n
                if s.vmax > vmax:
                    vmax = s.vmax
            for i, c in enumerate(sc):
                counts[i] += c
        return counts, total, n, vmax

    @property
    def count(self) -> int:
        return self._merged()[2]

    @property
    def sum(self) -> float:
        return self._merged()[1]

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]) — geometric bucket midpoint,
        bounded error from the log spacing."""
        counts, _total, n, vmax = self._merged()
        return self._percentile_from(counts, n, vmax, q)

    _percentile_from = staticmethod(percentile_from_counts)

    def state(self) -> Tuple[List[int], float, int, float]:
        """Merged raw state ``(counts, sum, n, vmax)`` — snapshot this
        twice and diff the counts for a windowed distribution view."""
        return self._merged()

    def snapshot(self) -> Dict[str, float]:
        counts, total, n, vmax = self._merged()
        out = {"count": n, "sum": total, "max": vmax}
        for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[name] = self._percentile_from(counts, n, vmax, q)
        return out

    def cumulative_buckets(self, every: int = 8
                           ) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs at reduced resolution —
        the Prometheus ``_bucket{le=...}`` series (last pair is +Inf)."""
        counts, _total, n, _vmax = self._merged()
        out: List[Tuple[float, int]] = []
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if (i + 1) % every == 0:
                out.append((bucket_bound(i), cum))
        out.append((math.inf, n))
        return out


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Name -> typed metric, with the legacy StatRegistry surface
    (``get``/``add``/``snapshot``) preserved for counters."""

    def __init__(self):
        # writes are serialized by _lock; READS are deliberately
        # lock-free (dict.get/items are GIL-atomic, entries are never
        # removed outside clear()) so hot observation sites don't
        # serialize process-wide on the registry — see _named()
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _named(self, name: str, cls) -> Metric:
        # lock-free fast path (dict.get is GIL-atomic): hot call sites
        # (per-step span timers, per-batch prepare, serving handlers)
        # resolve existing metrics without touching the registry lock —
        # otherwise every observation process-wide would serialize here
        # and defeat the histograms' lock striping
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls()
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._named(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._named(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._named(name, Histogram)

    # -- legacy StatRegistry surface -----------------------------------------

    def get(self, name: str) -> Counter:
        """Counter accessor (the StatRegistry.get of old)."""
        return self.counter(name)

    def add(self, name: str, n: Number = 1) -> None:
        self.counter(name).add(n)

    def observe(self, name: str, v: Number) -> None:
        self.histogram(name).observe(v)

    # -- export --------------------------------------------------------------

    def items(self) -> List[Tuple[str, Metric]]:
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self, prefix: str = "") -> Dict[str, Number]:
        """Flat scalar snapshot (optionally only names under ``prefix``):
        counters/gauges by name, histograms expanded to
        ``<name>.count/.sum/.p50/.p95/.p99/.max`` — e.g.
        ``snapshot("ingest.")`` is still the ingestion health report."""
        out: Dict[str, Number] = {}
        for name, m in self.items():
            if not name.startswith(prefix):
                continue
            if m.kind == "histogram":
                for k, v in m.snapshot().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = m.get()
        return out

    def clear(self) -> None:
        """Drop every metric (tests only — live code never resets)."""
        with self._lock:
            self._metrics.clear()


def delta(cur: Dict[str, Number], prev: Dict[str, Number]
          ) -> Dict[str, Number]:
    """Per-interval view of two ``snapshot()`` dicts: counters, gauges
    and histogram ``.count``/``.sum`` report their CHANGE over the
    interval; distribution shapes (``.p50/.p95/.p99/.max``) pass through
    current (subtracting quantiles is meaningless).  Keys absent from
    ``prev`` count from zero; zero-deltas are dropped."""
    out: Dict[str, Number] = {}
    for k, v in cur.items():
        base = k.rsplit(".", 1)[-1]
        if base in ("p50", "p95", "p99", "max"):
            if v:
                out[k] = v
            continue
        d = v - prev.get(k, 0)
        if d:
            out[k] = d
    return out


#: The process-global registry (``utils.monitor.STATS`` is this object).
REGISTRY = MetricsRegistry()
