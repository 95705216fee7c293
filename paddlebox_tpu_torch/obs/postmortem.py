"""Crash flight recorder: when a run dies, it leaves evidence (counterpart
of ``paddlebox_tpu/obs/postmortem.py``, the same bundle and file names).

:func:`dump_postmortem` freezes the observability state into one bundle
directory, committed through the checkpoint dir-commit
(``ckpt/atomic.py``: staging dir, manifest with sizes and crcs, rename),
so a crash during the dump never leaves a half bundle that looks whole:

- ``crash.json``: reason, exception and traceback, every thread's stack,
  pid and time;
- ``metrics.json``: the registry's snapshot (``obs/metrics.py``);
- ``alerts.json``: the alert state of every live SLO engine
  (``obs/slo.py``, ``all_alerts``), firing ones included;
- ``trace.json``: the tracer's ring buffers as Chrome trace JSON;
- ``heartbeat_tail.jsonl``: the last ``obs_postmortem_hb_tail`` lines of
  the heartbeat file, its rotated segments and its role sidecars;
- ``flags.json``: every ``PBOX_FLAGS_*`` flag the port reads, with its
  value (``config.all_flags``).

Armed by the ``obs_postmortem_dir`` flag (its ``PBOX_FLAGS_*`` variable,
read at each call; empty makes everything here a no-op). :func:`install`
chains ``sys.excepthook`` and ``threading.excepthook``, so an uncaught
exception dumps before the interpreter reports it; ``CTRTrainer``,
``PassManager`` and the checkpoint writer also call :func:`maybe_dump`
at their fatal sites, where an exception leaves the subsystem.

A dump is guarded against reentry and is best-effort: a broken sink never
masks the crash it records. One exception gives one bundle: a second dump
of the same exception (by id, type and message) within 60 s returns the
first bundle.

Imports neither torch nor numpy.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

from paddlebox_tpu_torch.config import all_flags, flag
from paddlebox_tpu_torch.obs.metrics import REGISTRY

#: heartbeat-tail length when the flag is unset or invalid
_HB_TAIL_DEFAULT = 200

_lock = threading.Lock()
_in_dump = False                     # guarded-by: _lock (reentrancy)
_installed = False
_prev_sys_hook = None
_prev_threading_hook = None
_last_bundle: Optional[str] = None
# one crash, one bundle: the same exception reaches a subsystem's fatal
# site and, re-raised, the process excepthook. Dedupe is by fingerprint
# within a window: holding the exception would pin its frames' locals.
_last_exc_key: Optional[tuple] = None          # guarded-by: _lock
_last_exc_time: float = 0.0                    # guarded-by: _lock
_DEDUPE_WINDOW_S = 60.0


def _exc_key(exc: BaseException) -> tuple:
    return (id(exc), type(exc).__name__, str(exc))


def _exc_doc(exc: Optional[BaseException]) -> Optional[Dict]:
    if exc is None:
        return None
    return {
        "type": type(exc).__name__,
        "message": str(exc),
        "traceback": "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__)),
    }


def _thread_stacks() -> List[Dict]:
    frames = sys._current_frames()
    threads = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = threads.get(ident)
        out.append({
            "name": t.name if t else f"<ident {ident}>",
            "ident": ident,
            "daemon": t.daemon if t else None,
            "stack": traceback.format_stack(frame),
        })
    return out


def _segment_tail(path: str) -> List[str]:
    """The last MiB of one file, as lines (never the whole file)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - (1 << 20)))
            return f.read().decode(errors="replace").splitlines()
    except OSError:
        return []


def _sidecar_files(path: str) -> List[str]:
    """Role sidecars beside ``path`` (``<path>.<role>``,
    ``heartbeat.sink_path``). A numeric suffix is a rotation of the file
    itself, not a sidecar."""
    out: List[str] = []
    d, base = os.path.split(path)
    try:
        names = os.listdir(d or ".")
    except OSError:
        return out
    prefix = base + "."
    for name in sorted(names):
        if not name.startswith(prefix):
            continue
        if name[len(prefix):].rpartition(".")[2].isdigit():
            continue
        out.append(os.path.join(d, name))
    return out


def _heartbeat_tail(n: int) -> List[str]:
    """The last ``n`` heartbeat lines of the file and of each sidecar,
    topped up from their rotated segments, oldest first."""
    path = flag("obs_heartbeat_path")
    if not path:
        return []
    keep = max(1, int(flag("obs_heartbeat_keep")))
    out: List[str] = []
    for primary in [path] + _sidecar_files(path):
        lines: List[str] = []
        for seg in [primary] + [f"{primary}.{i}"
                                for i in range(1, keep + 1)]:
            if len(lines) >= n:
                break
            if not os.path.exists(seg):
                continue
            lines = _segment_tail(seg)[-(n - len(lines)):] + lines
        out.extend(lines[-n:])
    return out


def dump_postmortem(reason: str, exc: Optional[BaseException] = None,
                    out_dir: Optional[str] = None,
                    extra: Optional[Dict] = None) -> Optional[str]:
    """Write one bundle under ``out_dir`` (default: the
    ``obs_postmortem_dir`` flag); returns its path, or None when a sink
    failed or another thread is dumping (a crash path never waits on its
    own telemetry)."""
    global _in_dump, _last_bundle, _last_exc_key, _last_exc_time
    root = out_dir or flag("obs_postmortem_dir")
    if not root:
        return None
    with _lock:
        if _in_dump:
            return None
        if exc is not None and _last_exc_key == _exc_key(exc) \
                and time.monotonic() - _last_exc_time < _DEDUPE_WINDOW_S:
            return _last_bundle
        _in_dump = True
    try:
        # imported here: the checkpoint writer imports this module at its
        # fatal site, and ckpt/ imports obs/ at import time
        from paddlebox_tpu_torch.ckpt import atomic as ckpt_atomic
        from paddlebox_tpu_torch.obs import slo, trace

        stamp = time.strftime("%Y%m%d-%H%M%S")
        final = os.path.join(
            root, f"postmortem-{stamp}-{os.getpid()}-"
                  f"{int(time.time() * 1e3) % 100000:05d}")
        staging = ckpt_atomic.stage_dir(final)

        def _write(name: str, obj) -> None:
            with open(os.path.join(staging, name), "w") as f:
                if name.endswith(".jsonl"):
                    f.write("\n".join(obj) + ("\n" if obj else ""))
                else:
                    json.dump(obj, f, indent=1, default=str)

        tail_n = int(flag("obs_postmortem_hb_tail") or _HB_TAIL_DEFAULT)
        _write("crash.json", {
            "reason": reason, "ts": time.time(), "pid": os.getpid(),
            "exception": _exc_doc(exc),
            "threads": _thread_stacks(),
            "extra": extra or {},
        })
        _write("metrics.json", REGISTRY.snapshot())
        _write("alerts.json", slo.all_alerts())
        _write("trace.json", {"traceEvents": trace.TRACE.events(),
                              "displayTimeUnit": "ms"})
        _write("heartbeat_tail.jsonl", _heartbeat_tail(tail_n))
        _write("flags.json", all_flags())
        ckpt_atomic.commit_dir(staging, final)
        REGISTRY.add("obs.postmortem.bundles")
        with _lock:
            _last_bundle = final
            if exc is not None:
                _last_exc_key = _exc_key(exc)
                _last_exc_time = time.monotonic()
        print(f"postmortem bundle written: {final}", file=sys.stderr)
        return final
    except Exception:  # noqa: BLE001 - evidence never masks the crash
        return None
    finally:
        with _lock:
            _in_dump = False


def maybe_dump(reason: str, exc: Optional[BaseException] = None,
               extra: Optional[Dict] = None) -> Optional[str]:
    """Fatal-site hook: a no-op (no I/O) unless ``obs_postmortem_dir`` is
    set; ``KeyboardInterrupt`` and ``SystemExit`` are not crashes."""
    if not flag("obs_postmortem_dir"):
        return None
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return None
    return dump_postmortem(reason, exc=exc, extra=extra)


def last_bundle() -> Optional[str]:
    with _lock:
        return _last_bundle


def install() -> None:
    """Chain the process's excepthooks (once). The previous hooks still
    run: this only adds the dump."""
    global _installed, _prev_sys_hook, _prev_threading_hook
    with _lock:
        if _installed:
            return
        _installed = True
        _prev_sys_hook = sys.excepthook
        _prev_threading_hook = threading.excepthook

    def sys_hook(exc_type, exc, tb):
        maybe_dump("sys.excepthook", exc=exc)
        _prev_sys_hook(exc_type, exc, tb)

    def threading_hook(args):
        maybe_dump(f"thread {getattr(args.thread, 'name', '?')} died",
                   exc=args.exc_value)
        _prev_threading_hook(args)

    sys.excepthook = sys_hook
    threading.excepthook = threading_hook


def maybe_install() -> bool:
    """Install the excepthooks when ``obs_postmortem_dir`` is set: the
    long-running entry points (``CTRTrainer``, ``PassManager``) call it at
    construction, as they call ``trace.maybe_enable``."""
    if flag("obs_postmortem_dir"):
        install()
        return True
    return False
