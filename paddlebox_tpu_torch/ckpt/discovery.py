"""Checkpoint discovery: from a donefile trail to a verified restore plan
(counterpart of ``paddlebox_tpu/ckpt/discovery.py``).

A plan is the newest base whose manifest verifies and the longest verified
delta chain after it. ``donefile.resume_candidates`` already drops records
whose paths vanished; this layer verifies every artifact (size and
checksum) before it may enter a plan. An unverifiable base disqualifies
its candidate (resume falls back to the base before it); an unverifiable
delta cuts its chain there, since later deltas carry only rows dirty since
it. ``quantized_sibling`` finds the int8 serving snapshot committed beside a
base or delta (``<dir>.q8``), which no plan ever holds.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

from paddlebox_tpu_torch.ckpt import atomic
from paddlebox_tpu_torch.trainer import donefile
from paddlebox_tpu_torch.utils.checkpoint import load_dense as _load_dense

#: A restore plan: (base donefile record, verified delta records in apply
#: order). ``record["path"]`` is the committed artifact dir.
Plan = Tuple[Dict, List[Dict]]


def verified_candidates(root: str) -> Iterator[Plan]:
    """Restore plans newest base first, every artifact verified: a base
    that fails verification is skipped with a warning, a failing delta
    cuts its chain."""
    for base, deltas in donefile.resume_candidates(root):
        try:
            atomic.verify(base["path"])
        except atomic.IntegrityError as e:
            warnings.warn(f"ckpt discovery: skipping unverifiable base "
                          f"{base['path']}: {e}")
            continue
        good: List[Dict] = []
        for d in deltas:
            try:
                atomic.verify(d["path"])
            except atomic.IntegrityError as e:
                warnings.warn(f"ckpt discovery: truncating delta chain "
                              f"at unverifiable {d['path']}: {e}")
                break
            good.append(d)
        yield base, good


def latest_committed(root: str) -> Optional[Plan]:
    """The newest fully verified restore plan under ``root``, or None."""
    for plan in verified_candidates(root):
        return plan
    return None


def apply_plan(ps, plan: Plan) -> None:
    """Load a verified plan into a ``SparsePS``: the base wholesale, then
    every delta in order."""
    base, deltas = plan
    ps.load_base(base["path"])
    for d in deltas:
        ps.load_delta(d["path"])


def load_dense(plan: Plan, template: Any) -> Optional[Any]:
    """Load the plan's base ``dense.npz`` (deltas carry no dense state)
    into ``template``, a ``(model, opt_state)`` pair, in place, every leaf
    checked against it first, and return it; None when the base has no
    dense state or no template is given."""
    if template is None:
        return None
    base, _deltas = plan
    path = os.path.join(base["path"], "dense.npz")
    if not os.path.exists(path):
        return None
    return _load_dense(path, template)


#: suffix of the derived int8 serving snapshot committed beside a base or
#: delta dir under ``serve_quantized``
QUANT_SUFFIX = ".q8"


def quantized_sibling(path: str) -> Optional[str]:
    """The verified quantized serving snapshot beside a base or delta dir
    (``<path>.q8``), or None when it is absent or fails its manifest. It
    is derived: no donefile record names it, it anchors no delta chain,
    and a consumer that finds it missing quantizes the float32 artifact on
    load, so a crash mid-export degrades a reload, never breaks one."""
    q8 = path + QUANT_SUFFIX
    if not os.path.isdir(q8):
        return None
    try:
        # a .q8 dir is always committed with a manifest; one without is
        # damaged, not legacy
        atomic.verify(q8, require_manifest=True)
    except atomic.IntegrityError as e:
        warnings.warn(f"ckpt discovery: ignoring unverifiable quantized "
                      f"snapshot {q8}: {e}")
        return None
    return q8


def plan_version(plan: Plan) -> Tuple[str, int]:
    """(day, pass_id) of the newest record a plan applies."""
    base, deltas = plan
    last = deltas[-1] if deltas else base
    return str(last["day"]), int(last["pass_id"])
