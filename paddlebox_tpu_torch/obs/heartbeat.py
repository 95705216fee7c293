"""Structured per-pass heartbeat: one JSON line a lifecycle event
(counterpart of ``paddlebox_tpu/obs/heartbeat.py``).

``CTRTrainer`` emits a ``pass`` record at the end of each training pass
(steps, step rate, span means, AUC, and ``host_share``, the share of the
pass the training thread spent on host feed work), ``PassManager`` an
``end_pass`` record (day and pass, the ingest delta, the checkpoint lag,
table occupancy, disk deltas). A record goes to the
``paddlebox_tpu_torch.obs`` logger at INFO and, when the reference's
``obs_heartbeat_path`` flag names a file (its ``PBOX_FLAGS_*`` variable,
read at each emit), is appended to that JSONL file, without fsync.

Every record carries ``hb`` (its kind), ``ts`` (unix seconds) and
``pid``, and ``role`` when ``obs_role`` names this process's role, whose
records then go to a sidecar ``<path>.<role>`` (``sink_path()``). The rest
is the kind's own, made JSON-plain (numpy scalars become Python ones).

Rotation: with ``obs_heartbeat_max_bytes`` > 0, a file past that size
rotates, ``hb.jsonl -> hb.jsonl.1 -> ... -> hb.jsonl.K`` by atomic
renames, keeping ``obs_heartbeat_keep`` (3) segments. Lines written to the
file count in ``heartbeat.lines_written``.

Imports neither torch nor numpy.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict

from paddlebox_tpu_torch.config import env_flag
from paddlebox_tpu_torch.obs.metrics import REGISTRY

LOG = logging.getLogger("paddlebox_tpu_torch.obs")

# default of the reference's obs_heartbeat_keep flag
OBS_HEARTBEAT_KEEP = 3

_lock = threading.Lock()


def _coerce(v: Any):
    """JSON-proof a value (numpy scalars/arrays, sets, exceptions)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _coerce(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_coerce(x) for x in v]
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()            # numpy scalar -> python scalar
        except (TypeError, ValueError):
            pass
    tolist = getattr(v, "tolist", None)
    if callable(tolist):
        try:
            return tolist()
        except (TypeError, ValueError):
            pass
    return str(v)


def _rotate_locked(path: str) -> None:
    """Size-based keep-K rotation (caller holds ``_lock``).  Atomic
    renames only: a reader concurrently tailing ``path`` sees either the
    old segment or a fresh empty file, never a truncated middle."""
    max_bytes = int(env_flag("obs_heartbeat_max_bytes", 0))
    if max_bytes <= 0:
        return
    try:
        if os.path.getsize(path) < max_bytes:
            return
        keep = max(1, int(env_flag("obs_heartbeat_keep",
                                  OBS_HEARTBEAT_KEEP)))
        oldest = f"{path}.{keep}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for i in range(keep - 1, 0, -1):
            seg = f"{path}.{i}"
            if os.path.exists(seg):
                os.replace(seg, f"{path}.{i + 1}")
        os.replace(path, f"{path}.1")
    except OSError as e:             # rotation failure must not stop
        LOG.warning("heartbeat rotation of %s failed: %s", path, e)


def sink_path() -> str:
    """Effective heartbeat file of THIS process: a spawned child with a
    fleet role (``obs_role``) writes a role-suffixed SIDECAR next to
    the inherited path (``hb.jsonl.host0``) so child records never
    interleave with the parent's; everyone else writes the path
    itself.  Empty when the file sink is disabled."""
    path = env_flag("obs_heartbeat_path", "")
    if not path:
        return ""
    role = str(env_flag("obs_role", ""))
    return f"{path}.{role}" if role else path


def emit(kind: str, **fields) -> Dict[str, Any]:
    """Emit one heartbeat record; returns the dict that was written."""
    rec: Dict[str, Any] = {"hb": kind, "ts": round(time.time(), 3),
                           "pid": os.getpid()}
    role = str(env_flag("obs_role", ""))
    if role:
        rec["role"] = role
    for k, v in fields.items():
        rec[k] = _coerce(v)
    line = json.dumps(rec)
    LOG.info("%s", line)
    path = sink_path()
    if path:
        try:
            with _lock:              # interleaved lines, never torn ones
                with open(path, "a") as f:
                    f.write(line + "\n")
                _rotate_locked(path)
            REGISTRY.add("heartbeat.lines_written")
        except OSError as e:         # telemetry never kills the pass
            LOG.warning("heartbeat append to %s failed: %s", path, e)
    return rec
