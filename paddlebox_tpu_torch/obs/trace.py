"""Thread-aware nested span tracer with Chrome trace-event export
(counterpart of ``paddlebox_tpu/obs/trace.py``).

    with trace.span("feed.pack"):
        ...

records one complete (``"ph": "X"``) event on the calling thread's ring
buffer; ``dump()`` merges every thread's buffer into one Chrome
trace-event JSON that loads in perfetto or chrome://tracing. Nesting is by
timestamp and duration within a thread; each thread has its own buffer and
a ``thread_name`` metadata event.

Disabled is the default and costs nothing: ``span()`` returns one shared
no-op context manager (no allocation, no lock, no clock read), so spans
stay in hot loops. ``maybe_enable()`` turns tracing on from the
reference's ``obs_trace_dir`` flag (its ``PBOX_FLAGS_obs_trace_dir``
variable, read at the call; ``CTRTrainer`` and ``PassManager`` call it at
construction), or ``enable(dir)`` does. Buffers are rings of
``obs_trace_ring`` events (65536): a long run keeps the most recent
window and counts what it drops in ``obs.trace.dropped_events``. An
enabled tracer also dumps at interpreter exit.

``TraceContext``, ``mint``, ``current``, ``from_wire`` and ``activate``
carry a request's trace identity as the reference's do: the serving tier
stamps it on its spans and carries it across the front door, the batcher
and a replica child's wire (``serving/``), and ``obs/collector.py`` links
the hops of one request across processes.

Imports neither torch nor numpy: the data feed's parse workers import it.
"""

from __future__ import annotations

import atexit
import binascii
import contextlib
import contextvars
import json
import os
import socket
import threading
import time
from typing import List, Optional

from paddlebox_tpu_torch.config import env_flag
from paddlebox_tpu_torch.obs.metrics import REGISTRY

# default of the reference's obs_trace_ring flag
OBS_TRACE_RING = 65536

#: Per-process launch nonce: distinguishes trace dumps from successive
#: processes that recycled the same pid (a respawned host child must not
#: clobber the dead child's undumped trace).  Computed ONCE at import so
#: repeated dump() calls keep overwriting the same current file.
LAUNCH_NONCE = binascii.hexlify(os.urandom(4)).decode("ascii")


def _new_id() -> str:
    """64-bit random hex id (trace_id / span_id)."""
    return binascii.hexlify(os.urandom(8)).decode("ascii")


class TraceContext:
    """Request-scoped distributed-trace identity, carried in a
    contextvar; the reference threads it as an additive field through
    every wire envelope.

    ``trace_id`` names the whole request; ``span_id`` is the id of the
    hop-edge that delivered the request here (the parent edge); ``hop``
    counts process boundaries crossed so far.  Peers lacking the wire
    field are treated as root spans — no WIRE_VERSION bump needed.
    """

    __slots__ = ("trace_id", "span_id", "hop")

    def __init__(self, trace_id: str, span_id: str, hop: int = 0):
        self.trace_id = trace_id
        self.span_id = span_id
        self.hop = hop

    def child(self) -> "TraceContext":
        """The outgoing-edge context stamped onto a wire request: same
        trace, fresh edge id, one hop deeper."""
        return TraceContext(self.trace_id, _new_id(), self.hop + 1)

    def to_wire(self) -> dict:
        return {"tid": self.trace_id, "sid": self.span_id,
                "hop": self.hop}

    def __repr__(self) -> str:
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, hop={self.hop})")


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "pbx_trace_ctx", default=None)


def mint() -> TraceContext:
    """A fresh root context (hop 0) — entry points call this when a
    request arrives with no wire context."""
    return TraceContext(_new_id(), _new_id(), 0)


def current() -> Optional[TraceContext]:
    """The active context of the calling thread/task, or None."""
    return _CTX.get()


def from_wire(obj) -> Optional[TraceContext]:
    """Parse the additive wire field back into a context.  Absent or
    malformed (a legacy peer, a fuzzer) -> None: the receiver mints a
    root span instead of failing the request."""
    if not isinstance(obj, dict):
        return None
    tid = obj.get("tid")
    sid = obj.get("sid")
    if not isinstance(tid, str) or not isinstance(sid, str):
        return None
    try:
        hop = int(obj.get("hop", 0))
    except (TypeError, ValueError):
        return None
    return TraceContext(tid, sid, hop)


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """``with trace.activate(ctx): ...`` — spans recorded inside are
    stamped with the context.  None is accepted (no-op body)."""
    if ctx is None:
        yield None
        return
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


class _NullSpan:
    """The disabled-path context manager: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._emit(self._name, self._t0, t1 - self._t0,
                           self._args)
        return False


class _ThreadBuf(threading.local):
    """Per-thread event buffer handle (thread-local indirection)."""

    def __init__(self):
        self.events = None           # set per thread by Tracer._buf


class Tracer:
    def __init__(self, ring: Optional[int] = None):
        self._enabled = False
        self._dir: Optional[str] = None
        self._ring = ring
        self._local = _ThreadBuf()
        # [(tid, thread_name, ring)] — threads REGISTER once (under
        # _lock) and then append lock-free to their own ring.  A LIST,
        # not an ident-keyed dict: CPython recycles thread idents, and a
        # recycled ident must never overwrite a dead thread's undumped
        # spans (e.g. a closed ckpt-writer's ckpt.commit events).  tid is
        # a registration sequence number, unique per thread for the
        # tracer's lifetime; the real thread name rides alongside.
        self._buffers: List[tuple] = []        # guarded-by: _lock
        self._lock = threading.Lock()
        self._epoch_wall = time.time()
        self._epoch_perf = time.perf_counter()
        self._atexit_armed = False             # guarded-by: _lock

    # -- lifecycle -----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, trace_dir: str, ring: Optional[int] = None) -> None:
        """Turn tracing on; ``dump()`` (and an atexit hook) write the
        Chrome trace JSON into ``trace_dir``."""
        os.makedirs(trace_dir, exist_ok=True)
        with self._lock:
            self._dir = trace_dir
            if ring is not None:
                self._ring = ring
            if not self._atexit_armed:
                self._atexit_armed = True
                atexit.register(self._dump_at_exit)
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def maybe_enable(self) -> bool:
        """Enable from the ``obs_trace_dir`` flag if set (idempotent);
        returns the resulting enabled state.  Every long-running entry
        point (trainer, pass manager, server, bench) calls this once."""
        if self._enabled:
            return True
        d = env_flag("obs_trace_dir", "")
        if d:
            self.enable(d, ring=int(env_flag("obs_trace_ring",
                                                   OBS_TRACE_RING)))
            return True
        return False

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **args):
        """``with trace.span("pull"): ...`` — a complete event on the
        calling thread.  Disabled: returns the shared no-op singleton."""
        if not self._enabled:
            return _NULL_SPAN
        ctx = _CTX.get()
        if ctx is not None:
            args["trace"] = ctx.trace_id
            args["hop"] = ctx.hop
            args["parent"] = ctx.span_id
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event."""
        if not self._enabled:
            return
        ctx = _CTX.get()
        if ctx is not None:
            args["trace"] = ctx.trace_id
            args["hop"] = ctx.hop
            args["parent"] = ctx.span_id
        t = time.perf_counter()
        self._emit(name, t, 0.0, args or None, ph="i")

    def _buf(self) -> list:
        ev = self._local.events
        if ev is None:
            from collections import deque
            ring = self._ring or int(env_flag("obs_trace_ring",
                                                     OBS_TRACE_RING))
            ev = deque(maxlen=max(ring, 16))
            self._local.events = ev
            th = threading.current_thread()
            with self._lock:
                self._buffers.append((len(self._buffers), th.name, ev))
        return ev

    def _emit(self, name: str, t0: float, dur: float,
              args: Optional[dict], ph: str = "X") -> None:
        buf = self._buf()
        if len(buf) == buf.maxlen:
            REGISTRY.add("obs.trace.dropped_events")
        ts_us = (t0 - self._epoch_perf) * 1e6
        buf.append((ph, name, ts_us, dur * 1e6, args))

    # -- export --------------------------------------------------------------

    def events(self) -> List[dict]:
        """All buffered events as Chrome trace-event dicts (merged across
        threads; stable order by timestamp)."""
        pid = os.getpid()
        with self._lock:
            bufs = [(tid, nm, list(ev)) for tid, nm, ev in self._buffers]
        out: List[dict] = []
        for tid, tname, evs in bufs:
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
            for ph, name, ts, dur, args in evs:
                e = {"ph": ph, "name": name, "pid": pid, "tid": tid,
                     "ts": ts}
                if ph == "X":
                    e["dur"] = dur
                if args:
                    e["args"] = args
                out.append(e)
        out.sort(key=lambda e: (0 if e["ph"] == "M" else 1,
                                e.get("ts", 0.0)))
        return out

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write ONE Chrome trace-event JSON (perfetto-loadable).  Default
        path is ``<trace_dir>/pbx_trace_<pid>_<nonce>.json`` — the launch
        nonce keeps a respawned process that recycled the pid from
        clobbering its predecessor's dump — overwritten on each dump so a
        process always leaves exactly one current file.  Returns the
        path (None when tracing never enabled and no path given)."""
        if path is None:
            if self._dir is None:
                return None
            path = os.path.join(
                self._dir,
                f"pbx_trace_{os.getpid()}_{LAUNCH_NONCE}.json")
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "paddlebox_tpu_torch.obs.trace",
                "epoch_unix_s": self._epoch_wall,
                "pid": os.getpid(),
                "launch_nonce": LAUNCH_NONCE,
                "role": str(env_flag("obs_role", "")) or None,
                "host": socket.gethostname(),
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def _dump_at_exit(self) -> None:
        try:
            self.dump()
        except OSError:
            pass                     # exit-path best effort

    def clear(self) -> None:
        """Drop buffered events (buffers stay registered)."""
        with self._lock:
            for _tid, _name, ev in self._buffers:
                ev.clear()


#: Process-global tracer; module-level helpers delegate to it.
TRACE = Tracer()

span = TRACE.span
instant = TRACE.instant
enable = TRACE.enable
disable = TRACE.disable
maybe_enable = TRACE.maybe_enable
dump = TRACE.dump


def enabled() -> bool:
    return TRACE.enabled
