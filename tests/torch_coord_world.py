"""Ranks as threads for the multi-host tests: ``run_ranks`` and the
coordinator dataset exchanges of two ranks in either package."""

import threading

from paddlebox_tpu.data import dataset as ref_dataset
from paddlebox_tpu.parallel import coordinator as ref_coord
from paddlebox_tpu_torch.data import dataset as port_dataset
from paddlebox_tpu_torch.parallel import coordinator as port_coord

PACKAGES = {"ref": (ref_dataset, ref_coord),
            "port": (port_dataset, port_coord)}


def run_ranks(fn, coords, timeout=120):
    """``fn(rank, coord)`` on a thread a rank; closes the coordinators,
    re-raises the first failure, returns the results in rank order."""
    results = [None] * len(coords)
    errors = [None] * len(coords)

    def wrap(r):
        try:
            results[r] = fn(r, coords[r])
        except Exception as e:  # noqa: BLE001 - raised below
            errors[r] = e

    threads = [threading.Thread(target=wrap, args=(r,))
               for r in range(len(coords))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    hung = [r for r, t in enumerate(threads) if t.is_alive()]
    for c in coords:
        c.close()
    assert not hung, f"rank threads hung: {hung}"
    for e in errors:
        if e is not None:
            raise e
    return results


def world(package: str, n: int):
    """``n`` coordinators of ``package`` ("ref" or "port") on free
    localhost ports."""
    coord = PACKAGES[package][1]
    eps = coord.local_endpoints(n)
    return [coord.Coordinator(r, eps) for r in range(n)]


def exchange(package: str, what: str, datasets, merge_size: int = 2):
    """Each dataset a rank: ``coordinator_global_shuffle`` ("shuffle") or
    ``coordinator_global_merge_by_insid`` ("merge"); returns the ranks'
    results (None, or the dropped counts)."""
    mod = PACKAGES[package][0]
    if what == "merge":
        def fn(r, c):
            return mod.coordinator_global_merge_by_insid(
                datasets[r], c, merge_size=merge_size)
    else:
        def fn(r, c):
            return mod.coordinator_global_shuffle(datasets[r], c)
    return run_ranks(fn, world(package, len(datasets)))
