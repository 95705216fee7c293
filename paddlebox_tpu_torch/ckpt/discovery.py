"""Checkpoint discovery: from a donefile trail to a verified restore plan
(counterpart of ``paddlebox_tpu/ckpt/discovery.py``).

A plan is the newest base whose manifest verifies and the longest verified
delta chain after it. ``donefile.resume_candidates`` already drops records
whose paths vanished; this layer verifies every artifact (size and
checksum) before it may enter a plan. An unverifiable base disqualifies
its candidate (resume falls back to the base before it); an unverifiable
delta cuts its chain there, since later deltas carry only rows dirty since
it. The quantized serving sibling (``quantized_sibling``, ``<dir>.q8``) is
ROADMAP A.1 and has no counterpart here.
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


def plan_version(plan: Plan) -> Tuple[str, int]:
    """(day, pass_id) of the newest record a plan applies."""
    base, deltas = plan
    last = deltas[-1] if deltas else base
    return str(last["day"]), int(last["pass_id"])
