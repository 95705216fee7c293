"""Merge a trace dir's per-process dumps into one timeline (counterpart of
``paddlebox_tpu/obs/collector.py``).

Every process of a serving fleet (the parent, each process-scope replica
child) dumps its own ``pbx_trace_<pid>_<nonce>.json`` into the shared
``obs_trace_dir`` (``obs/trace.py``). ``collect(trace_dir)`` merges them:

- epochs: each dump records its wall-clock epoch
  (``otherData.epoch_unix_s``); events shift onto the earliest one, so a
  request's hops line up on one time axis;
- pid collisions: a dump whose pid an earlier dump already claimed (a
  respawned child that recycled it) gets a synthetic pid, and every
  process gets a ``process_name`` event naming its role, pid and nonce;
- flows: spans stamped with a trace context carry ``args.trace`` and
  ``args.hop``; each consecutive hop pair of a trace gets a Chrome flow
  (``"ph": "s"`` at the parent hop's first span, ``"ph": "f"`` at the
  child hop's), which perfetto draws as an arrow across processes.

The merge reads dumps of either package and skips either collector's own
output. CLI::

    python -m paddlebox_tpu_torch.obs.collector <trace_dir> [-o merged.json]

Imports neither torch nor numpy.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

#: current nonce-suffixed dumps and pre-nonce ``pbx_trace_<pid>.json``
DUMP_GLOB = "pbx_trace_*.json"

TOOL = "paddlebox_tpu_torch.obs.collector"
#: this collector's output and the reference's, never merged again
_COLLECTORS = (TOOL, "paddlebox_tpu.obs.collector")

#: synthetic pids for collisions start here, above any real pid
_SYNTH_PID_BASE = 10_000_000


def _load_dumps(trace_dir: str) -> List[dict]:
    """Every dump in the dir; a torn file (a process died mid-dump) is
    skipped."""
    docs = []
    for path in sorted(glob.glob(os.path.join(trace_dir, DUMP_GLOB))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) or "traceEvents" not in doc:
            continue
        other = doc.get("otherData")
        if isinstance(other, dict) and other.get("tool") in _COLLECTORS:
            continue
        doc["_path"] = path
        docs.append(doc)
    return docs


def _proc_label(other: dict) -> str:
    label = str(other.get("role") or "proc")
    if other.get("pid") is not None:
        label += f" pid={other['pid']}"
    if other.get("launch_nonce"):
        label += f" nonce={other['launch_nonce']}"
    return label


def collect(trace_dir: str) -> dict:
    """One Chrome-trace document of every dump under ``trace_dir``."""
    docs = _load_dumps(trace_dir)
    events: List[dict] = []
    sources: List[dict] = []
    used_pids: Dict[int, str] = {}       # effective pid -> source path
    synth = _SYNTH_PID_BASE
    epochs = [float(d.get("otherData", {}).get("epoch_unix_s", 0.0))
              for d in docs]
    origin = min((e for e in epochs if e > 0.0), default=0.0)

    for doc, epoch in zip(docs, epochs):
        other = doc.get("otherData", {})
        evs = [e for e in doc.get("traceEvents", []) if isinstance(e, dict)]
        file_pid = other.get("pid")
        if file_pid is None:             # pre-nonce dump: from its events
            file_pid = next((e.get("pid") for e in evs
                             if e.get("pid") is not None), 0)
        eff_pid = int(file_pid)
        if eff_pid in used_pids:         # pid reuse across launches
            eff_pid = synth
            synth += 1
        used_pids[eff_pid] = doc["_path"]
        shift_us = (epoch - origin) * 1e6 if epoch > 0.0 else 0.0

        events.append({"ph": "M", "name": "process_name", "pid": eff_pid,
                       "tid": 0, "args": {"name": _proc_label(other)}})
        for e in evs:
            e = dict(e)
            e["pid"] = eff_pid
            if "ts" in e and e["ph"] != "M":
                e["ts"] = float(e["ts"]) + shift_us
            events.append(e)
        sources.append({"path": os.path.basename(doc["_path"]),
                        "pid": int(file_pid), "effective_pid": eff_pid,
                        "role": other.get("role"),
                        "launch_nonce": other.get("launch_nonce"),
                        "host": other.get("host"),
                        "epoch_unix_s": epoch})

    events.extend(_flow_events(events))
    events.sort(key=lambda e: (0 if e["ph"] == "M" else 1,
                               e.get("ts", 0.0)))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": TOOL,
            "sources": sources,
            "traces": sorted(_trace_ids(events)),
        },
    }


def _trace_ids(events: List[dict]) -> set:
    out = set()
    for e in events:
        args = e.get("args")
        if isinstance(args, dict) and "trace" in args:
            out.add(args["trace"])
    return out


def _flow_events(events: List[dict]) -> List[dict]:
    """A flow pair for each consecutive hop pair of each trace, from the
    parent hop's first stamped span to the child hop's first."""
    by_trace: Dict[str, Dict[int, dict]] = {}
    for e in events:
        args = e.get("args")
        if e.get("ph") not in ("X", "i") or not isinstance(args, dict):
            continue
        trace_id = args.get("trace")
        hop = args.get("hop")
        if trace_id is None or not isinstance(hop, int):
            continue
        hops = by_trace.setdefault(trace_id, {})
        cur = hops.get(hop)
        if cur is None or e.get("ts", 0.0) < cur.get("ts", 0.0):
            hops[hop] = e
    flows: List[dict] = []
    for trace_id, hops in by_trace.items():
        order = sorted(hops)
        for a, b in zip(order, order[1:]):
            src, dst = hops[a], hops[b]
            fid = f"{trace_id}:{a}"
            flows.append({"ph": "s", "id": fid, "cat": "trace",
                          "name": "hop", "pid": src["pid"],
                          "tid": src["tid"], "ts": src["ts"]})
            flows.append({"ph": "f", "bp": "e", "id": fid, "cat": "trace",
                          "name": "hop", "pid": dst["pid"],
                          "tid": dst["tid"], "ts": dst["ts"]})
    return flows


def write(trace_dir: str, out_path: Optional[str] = None
          ) -> Tuple[str, dict]:
    """Collect ``trace_dir`` and write the merged timeline (default
    ``<trace_dir>/pbx_trace_merged.json``); returns (path, doc)."""
    doc = collect(trace_dir)
    if out_path is None:
        out_path = os.path.join(trace_dir, "pbx_trace_merged.json")
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)
    return out_path, doc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Merge per-process pbx trace dumps into one "
                    "perfetto-loadable timeline.")
    ap.add_argument("trace_dir", help="Directory of pbx_trace_*.json dumps")
    ap.add_argument("-o", "--out", default=None,
                    help="Output path (default <dir>/pbx_trace_merged.json)")
    ns = ap.parse_args(argv)
    if not os.path.isdir(ns.trace_dir):
        print(f"not a directory: {ns.trace_dir}")
        return 2
    path, doc = write(ns.trace_dir, ns.out)
    other = doc["otherData"]
    print(f"merged {len(other['sources'])} dumps, "
          f"{len(doc['traceEvents'])} events, "
          f"{len(other['traces'])} traces -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
