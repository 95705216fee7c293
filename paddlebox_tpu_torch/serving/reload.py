"""Checkpoint hot reload: serve pass N while loading N+1, then swap
(counterpart of ``paddlebox_tpu/serving/reload.py``).

A :class:`ReloadWatcher` polls the trainer's checkpoint root through
``ckpt/discovery.py`` ``latest_committed`` (the newest base whose
manifest verifies and the verified delta chain after it: what
``PassManager.resume`` restores) and, when a newer pass is committed:

1. builds the next predictor in the background with
   :func:`load_predictor_from_plan`, while every replica keeps serving
   pass N;
2. swaps the replicas one at a time (``Replica.swap_predictor`` between
   dispatches; a process-scope child rebuilds and swaps in its own
   process), so the fleet spans at most two adjacent versions and no
   request sees a half-loaded model;
3. records ``serving.reload_ms`` a replica and ``serving.reloads`` a
   fleet transition; the predictor's ``fwd_fingerprint`` ledger counts a
   swap onto another forward in ``serving.reload_recompiled``.

``model_version`` becomes ``<day>/<pass_id:05d>`` of the newest record
applied. In thread scope the card holds, for a moment, the old and the
new table of the replica being swapped. The poll interval is the
``serve_reload_poll`` flag (``PBOX_FLAGS_serve_reload_poll``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from paddlebox_tpu_torch.ckpt import discovery
from paddlebox_tpu_torch.config import flag
from paddlebox_tpu_torch.models.convert import (flax_leaves_from_model,
                                                load_flax_leaves)
from paddlebox_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from paddlebox_tpu_torch.serving.batcher import ReplicaDead, ServingError
from paddlebox_tpu_torch.serving.fleet import ReplicaSet
from paddlebox_tpu_torch.utils.checkpoint import load_leaves


class ReloadError(ServingError):
    """A checkpoint plan could not be turned into a serving model."""


def _table_files(base_path: str) -> List[str]:
    """The table artifacts of a committed checkpoint dir: every
    ``<table>.npz`` but the dense state."""
    names = [f for f in sorted(os.listdir(base_path))
             if f.endswith(".npz") and f != "dense.npz"]
    if not names:
        raise ReloadError(f"no table artifacts in {base_path}")
    return names


def _load_quant(table, record_path: str, tf: str, delta: bool) -> None:
    """One record into a ``QuantServingTable``: the committed ``.q8``
    sibling when it verifies, else quantized on load from float32."""
    q8 = discovery.quantized_sibling(record_path)
    if q8 is not None and os.path.exists(os.path.join(q8, tf)):
        (table.load_delta if delta else table.load)(os.path.join(q8, tf))
    else:
        REGISTRY.add("serving.quant_fallbacks")
        (table.load_delta_f32 if delta else table.load_f32)(
            os.path.join(record_path, tf))


def load_predictor_from_plan(bundle_path: str, plan: discovery.Plan,
                             reload_of=None, ps_endpoints=None,
                             ps_table=None, device=None):
    """One serving predictor of a verified restore plan: model and feed
    from the bundle, the table from the base and its deltas in order
    (``ServingTable.load``/``load_delta``, or the quantized forms under
    ``serve_quantized``), the dense leaves from the base's ``dense.npz``
    when the trainer saved one (it holds exactly the model's flax leaves,
    ``models/convert.py``), else the bundle's. ``reload_of`` is the
    predictor it replaces (the fingerprint ledger); ``device`` defaults to
    its device, else ``cuda``. The uploads have finished when it returns,
    so another thread's stream may pull at once. ``ps_endpoints`` (with
    ``ps_table``), or else ``reload_of``'s, keeps the wiring of a predictor
    that serves through the PS service: the reload refreshes the dense
    leaves and the version, and the rows stay on the service."""
    from paddlebox_tpu_torch.inference.predictor import CTRPredictor

    if ps_endpoints is None and reload_of is not None:
        ps_endpoints = getattr(reload_of, "ps_endpoints", None)
        if ps_table is None:
            ps_table = getattr(reload_of, "ps_table", None)
    if device is None and reload_of is not None:
        device = getattr(reload_of, "device", None)
    base, deltas = plan
    if ps_endpoints:
        pred = CTRPredictor(bundle_path, device=device, reload_of=reload_of,
                            ps_endpoints=ps_endpoints,
                            ps_table=ps_table or "embedding")
        return _finish(pred, plan)
    # the checkpoint's rows replace the bundle's: its table is not loaded
    pred = CTRPredictor(bundle_path, device=device, reload_of=reload_of,
                        load_table=False)
    table_files = _table_files(base["path"])
    if len(table_files) > 1:
        raise ReloadError(
            f"bundle serves ONE table but {base['path']} holds "
            f"{table_files}; multi-table serving routes per-slot and is "
            f"not wired yet")
    tf = table_files[0]
    if pred.serves_quantized:
        # the int8 snapshot beside each record when it verifies (a smaller
        # read), else quantized on load: never a failed reload for it
        _load_quant(pred.table, base["path"], tf, delta=False)
        for d in deltas:
            _load_quant(pred.table, d["path"], tf, delta=True)
    else:
        pred.table.load(os.path.join(base["path"], tf))
        for d in deltas:
            pred.table.load_delta(os.path.join(d["path"], tf))
    return _finish(pred, plan)


def _finish(pred, plan: discovery.Plan):
    """The plan's dense leaves (when the base has them) and version into
    ``pred``, its uploads finished."""
    base, _deltas = plan
    dense_path = os.path.join(base["path"], "dense.npz")
    if os.path.exists(dense_path):
        load_flax_leaves(pred.model, load_leaves(
            dense_path, flax_leaves_from_model(pred.model)))
    day, pass_id = discovery.plan_version(plan)
    pred.model_version = f"{day}/{pass_id:05d}"
    if pred.device.type == "cuda":
        torch.cuda.current_stream(pred.device).synchronize()
    return pred


def _fleet_version(fleet: ReplicaSet) -> Optional[Tuple[str, int]]:
    """The lowest ``(day, pass_id)`` a replica serves, from the
    ``<day>/<pass:05d>`` tags this module writes; None when a replica has
    no such tag (the first poll then reloads)."""
    versions = []
    for v in fleet.versions():
        day, _, pid = (v or "").partition("/")
        if not (day.isdigit() and pid.isdigit()):
            return None
        versions.append((day, int(pid)))
    return min(versions) if versions else None


class ReloadWatcher:
    """Poll a checkpoint root and hot-reload the fleet on new passes.

    ``poll_once()`` is the deterministic unit (tests drive it); ``start()``
    runs it on a thread every ``serve_reload_poll`` seconds. A reload
    finishes before the next poll begins."""

    def __init__(self, fleet: ReplicaSet, bundle_path: str,
                 ckpt_root: str, poll_s: Optional[float] = None,
                 registry: MetricsRegistry = REGISTRY):
        self.fleet = fleet
        self.bundle_path = bundle_path
        self.ckpt_root = ckpt_root
        self.poll_s = (float(flag("serve_reload_poll"))
                       if poll_s is None else float(poll_s))
        self.registry = registry
        # from what the fleet serves: a replacement watcher over an
        # up-to-date fleet rebuilds nothing
        self.current: Optional[Tuple[str, int]] = _fleet_version(fleet)
        self.last_error: Optional[str] = None
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReloadWatcher":
        if self._closed.is_set():
            raise RuntimeError("reload watcher already stopped")
        th = threading.Thread(target=self._loop, daemon=True,
                              name="serve-reload")
        self._thread = th
        th.start()
        return self

    def stop(self) -> None:
        self._closed.set()
        th = self._thread
        if th is not None and th.is_alive():
            th.join(timeout=30.0)

    def __enter__(self) -> "ReloadWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._closed.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception as e:
                # a bad poll never ends the watcher: pass N keeps serving
                self.last_error = f"{type(e).__name__}: {e}"
                self.registry.add("serving.reload_errors")

    # -- the reload ----------------------------------------------------------

    def poll_once(self) -> bool:
        """One discovery tick: True when a newer committed pass was found
        and the whole fleet now serves it."""
        plan = discovery.latest_committed(self.ckpt_root)
        if plan is None:
            return False
        version = discovery.plan_version(plan)
        if self.current is not None and version <= self.current:
            return False
        self._apply(plan, version)
        return True

    def _apply(self, plan: discovery.Plan,
               version: Tuple[str, int]) -> None:
        """Swap every replica to ``plan``, one at a time."""
        # restarts first: one landing during the rollout rebuilds on it
        self.fleet.retarget(self.bundle_path, plan)
        for rep in self.fleet.replicas:
            # a dead replica is skipped (its restart builds on the plan),
            # and so is one that dies between this check and its swap
            if not rep.alive():
                continue
            t0 = time.perf_counter()
            try:
                if rep.scope == "process":
                    rep.reload_from_plan(self.bundle_path, plan)
                else:
                    pred = load_predictor_from_plan(
                        self.bundle_path, plan, reload_of=rep.predictor)
                    rep.swap_predictor(pred)
            except ReplicaDead:
                self.registry.add("serving.reload_dead_skips")
                continue
            self.registry.observe("serving.reload_ms",
                                  (time.perf_counter() - t0) * 1e3)
        self.current = version
        self.last_error = None
        self.registry.add("serving.reloads")
        self.registry.gauge("serving.model_pass").set(version[1])

    # -- introspection -------------------------------------------------------

    def status(self) -> Dict:
        return {
            "current": (f"{self.current[0]}/{self.current[1]:05d}"
                        if self.current else None),
            "poll_s": self.poll_s,
            "last_error": self.last_error,
            "fleet_versions": self.fleet.versions(),
        }
