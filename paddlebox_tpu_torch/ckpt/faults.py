"""Named crash points of the checkpoint commit pipeline (the part of
``paddlebox_tpu/ckpt/faults.py`` that the save path and its drills use).

The pipeline calls ``crash_point("delta.mid_write")`` and the like at each
state transition; ``arm(name)`` makes the Nth hit raise
:class:`InjectedCrash`, the in-process stand-in for ``kill -9`` at that
instant. ``InjectedCrash`` derives from ``BaseException`` so that cleanup
handlers written as ``except Exception`` (tmp-file unlink, retries) do not
catch it: a real crash cleans nothing up.

The seeded ``OSError`` injector, ``io_point`` and ``with_retries`` live in
``utils/faults.py`` and are re-exported here, as in the reference: there
is one process-global injector, and the commit pipeline's ``io_point``
call sites (``open``, ``rename``, ``commit_dir``, ``donefile.append``) and
the writer's retries go through it. Not ported: the point hooks
(``set_point_hook``), which only the reference's tests use.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from paddlebox_tpu_torch.utils.faults import (FaultInjector,
                                              install_injector, io_point,
                                              with_retries)

__all__ = [
    "InjectedCrash", "CRASH_POINTS", "arm", "disarm_all", "crash_point",
    # the shared core, re-exported from utils.faults
    "FaultInjector", "install_injector", "io_point", "with_retries",
]


class InjectedCrash(BaseException):
    """Simulated process death at a named crash point."""

    def __init__(self, point: str):
        super().__init__(f"injected crash at '{point}'")
        self.point = point


#: Every named crash point of the commit pipeline, in pipeline order.
CRASH_POINTS: Tuple[str, ...] = (
    "base.mid_write",        # some base artifacts written, others missing
    "base.before_manifest",  # all artifacts written, manifest missing
    "base.after_manifest",   # staging dir complete, rename not yet done
    "base.before_donefile",  # dir committed, donefile record missing
    "delta.mid_write",
    "delta.before_manifest",
    "delta.after_manifest",
    "delta.before_donefile",
    "donefile.mid_append",   # torn donefile line: partial JSON, no newline
    # the quantized serving export (serve_quantized): the <dir>.q8 commit
    # sits between the main dir's commit and the donefile append, and a
    # crash anywhere in it leaves the float32 trail whole
    "base.before_q8",        # main dir committed, .q8 export not begun
    "base.q8.before_manifest",
    "base.q8.after_manifest",
    "delta.before_q8",
    "delta.q8.before_manifest",
    "delta.q8.after_manifest",
)

# process-wide, as in the reference: a drill arms a point that the writer
# thread hits
_lock = threading.Lock()
_armed: Dict[str, int] = {}                    # point -> hits until crash


def arm(point: str, at_hit: int = 1) -> None:
    """Crash at the ``at_hit``-th future hit of ``point`` (1 = next hit)."""
    if point not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {point!r}; "
                         f"registered: {CRASH_POINTS}")
    if at_hit < 1:
        raise ValueError("at_hit must be >= 1")
    with _lock:
        _armed[point] = at_hit


def disarm_all() -> None:
    with _lock:
        _armed.clear()


def crash_point(point: str) -> None:
    """Pipeline call site: a no-op unless ``point`` is armed."""
    if point not in CRASH_POINTS:
        raise ValueError(f"unregistered crash point {point!r}")
    with _lock:
        n = _armed.get(point)
        if n is None:
            return
        if n > 1:
            _armed[point] = n - 1
            return
        del _armed[point]
    raise InjectedCrash(point)
