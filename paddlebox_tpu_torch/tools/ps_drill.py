"""PS-service drill: seeded failure and parity scenarios against the
networked sharded parameter server (``ps/service/``), each under a hard
wall-clock deadline (a hang is a failure); the counterpart of the
reference's ``tools/ps_drill.py``.

- ``parity``: a training pass through the service at 1, 2 and 4 shards
  gives the in-process ``SparsePS`` oracle's table bit for bit: every
  pull equal along the way, the merged snapshots equal at the end.
- ``shard_kill``: SIGKILL a shard right after a ``save_delta``; the
  client raises ``ShardUnavailable`` naming the shard and its endpoint;
  the shard restarts onto its base and delta, the client repoints and
  retries, training goes on, and the final table equals the never-killed
  oracle's: no update lost.
- ``slow_shard``: one shard answers seconds late; the request deadline
  expires, the budget is spent and ``ShardUnavailable`` comes fast, while
  the healthy shard keeps answering its slice.
- ``cache_wall``: coalesced serving batches (95% of each from a hot head
  that fits the cache, 5% from a cold tail) pulled through the service
  with and without the ``HotKeyCache`` in front, in pairs; the cached
  pulls must be faster on average. Prints its numbers (no history file).

Usage::

    python3 -m paddlebox_tpu_torch.tools.ps_drill              # all
    python3 -m paddlebox_tpu_torch.tools.ps_drill --scenario parity --seed 7
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from paddlebox_tpu_torch.config import TableConfig
from paddlebox_tpu_torch.obs.metrics import MetricsRegistry
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.service import (RemotePS, RemoteTable,
                                            ShardService, ShardUnavailable)
from paddlebox_tpu_torch.ps.sharded import shard_of
from paddlebox_tpu_torch.ps.table import EmbeddingTable

SCENARIO_DEADLINE = 120.0       # wall-clock cap of a scenario: a hang fails
#: parity spawns 1+2+4 shards and trains against each; cache_wall makes
#: hundreds of remote pulls
SCENARIO_DEADLINES = {"parity": 300.0, "cache_wall": 240.0}


def _table_conf(seed: int) -> TableConfig:
    return TableConfig(embedx_dim=8, cvm_offset=3, optimizer="adam",
                       learning_rate=0.05, embedx_threshold=0.0,
                       seed=seed)


def _grads(rng: np.random.Generator, keys: np.ndarray,
           dim: int) -> np.ndarray:
    g = rng.normal(0.0, 0.05, (keys.size, dim)).astype(np.float32)
    g[:, 0] = 1.0          # one show an occurrence
    g[:, 1] = (keys % np.uint64(7) == 0).astype(np.float32)
    return g


def _snapshots_equal(a: Dict[str, np.ndarray],
                     b: Dict[str, np.ndarray]) -> bool:
    return set(a) == set(b) and \
        all(np.array_equal(a[k], b[k]) for k in a)


def _oracle_snapshot(table: EmbeddingTable) -> Dict[str, np.ndarray]:
    snap = table.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"], kind="stable")
    return {k: v[order] for k, v in snap.items()}


# -- scenarios ---------------------------------------------------------------

def scenario_parity(seed: int, root: str) -> Dict:
    """Remote against local, bit for bit, at 1, 2 and 4 shards."""
    conf = _table_conf(seed)
    steps: List[str] = []
    for shards in (1, 2, 4):
        rng = np.random.default_rng(seed)
        oracle = SparsePS({"embedding": EmbeddingTable(conf)})
        reg = MetricsRegistry()
        with ShardService({"embedding": conf}, num_shards=shards,
                          registry=reg) as svc:
            client = svc.client(deadline_s=15.0, retries=1)
            remote = RemotePS(client, {"embedding": conf}, cache_rows=0)
            pool = rng.integers(1, 3000, 1800).astype(np.uint64)
            for pass_id in (1, 2):
                remote.begin_pass(pass_id)
                oracle.begin_pass(pass_id)
                remote.feed_pass({"embedding": pool})
                oracle.feed_pass({"embedding": pool})
                for _ in range(4):
                    kb = rng.choice(pool, 256).astype(np.uint64)
                    v_r = remote["embedding"].pull(kb)
                    v_o = oracle["embedding"].pull(kb)
                    if not np.array_equal(v_r, v_o):
                        return {"scenario": "parity", "ok": False,
                                "detail": f"shards={shards} pass="
                                          f"{pass_id}: pull diverged"}
                    g = _grads(rng, kb, conf.pull_dim)
                    remote["embedding"].push(kb, g)
                    oracle["embedding"].push(kb, g)
                remote.end_pass()
                oracle.end_pass()
            snap_r = remote["embedding"].merged_snapshot()
            snap_o = _oracle_snapshot(oracle["embedding"])
            if not _snapshots_equal(snap_r, snap_o):
                return {"scenario": "parity", "ok": False,
                        "detail": f"shards={shards}: final snapshot "
                                  "diverged"}
            per_shard = [sum(s["num_features"].values())
                         for s in svc.stats()]
            client.close()
        steps.append(f"shards={shards} rows={snap_o['keys'].size} "
                     f"per-shard={per_shard} bit-identical")
    return {"scenario": "parity", "ok": True, "detail": "; ".join(steps)}


def scenario_shard_kill(seed: int, root: str,
                        conf: Optional[TableConfig] = None,
                        pool: Optional[np.ndarray] = None,
                        batch: int = 192) -> Dict:
    """SIGKILL a shard mid-pass: ShardUnavailable, a restart onto base and
    delta, no update lost against the oracle. ``conf``, ``pool`` (the
    pass's keys) and ``batch`` (keys a step) default to the drill's small
    table."""
    conf = conf or _table_conf(seed)
    rng = np.random.default_rng(seed)
    reg = MetricsRegistry()
    oracle = SparsePS({"embedding": EmbeddingTable(conf)})
    steps: List[str] = []
    with ShardService({"embedding": conf}, num_shards=2,
                      root=os.path.join(root, "ckpt"),
                      registry=reg) as svc:
        client = svc.client(deadline_s=2.0, retries=1)
        remote = RemotePS(client, {"embedding": conf}, cache_rows=0)
        if pool is None:
            pool = rng.integers(1, 2500, 1500).astype(np.uint64)
        remote.begin_pass(1)
        oracle.begin_pass(1)
        remote.feed_pass({"embedding": pool})
        oracle.feed_pass({"embedding": pool})

        def step():
            kb = rng.choice(pool, batch).astype(np.uint64)
            v_r = remote["embedding"].pull(kb)
            v_o = oracle["embedding"].pull(kb)
            assert np.array_equal(v_r, v_o), "pull diverged"
            g = _grads(rng, kb, conf.pull_dim)
            remote["embedding"].push(kb, g)
            oracle["embedding"].push(kb, g)

        for _ in range(3):
            step()
        remote.save_base("d0", 1)
        for _ in range(2):
            step()
        # commit, then die with nothing uncommitted
        remote.save_delta("d0", 1)
        svc.kill(0)
        time.sleep(0.2)
        kb = rng.choice(pool, batch).astype(np.uint64)
        t0 = time.monotonic()
        try:
            remote["embedding"].pull(kb)
            return {"scenario": "shard_kill", "ok": False,
                    "detail": "pull against a SIGKILLed shard did not "
                              "raise"}
        except ShardUnavailable as e:
            surfaced = time.monotonic() - t0
            if e.shard != 0 or "127.0.0.1" not in e.endpoint:
                return {"scenario": "shard_kill", "ok": False,
                        "detail": f"missing shard/endpoint context: {e}"}
        steps.append(f"ShardUnavailable in {surfaced:.2f}s")
        t1 = time.monotonic()
        endpoint = svc.restart(0)
        restart_s = time.monotonic() - t1
        resumed = svc.handles[0].resumed
        if resumed != "d0/00001":
            return {"scenario": "shard_kill", "ok": False,
                    "detail": f"restart resumed {resumed!r}, want "
                              "'d0/00001' (base + replayed delta)"}
        client.repoint(0, endpoint)
        # the failed pull again, against the restarted shard
        v_r = remote["embedding"].pull(kb)
        v_o = oracle["embedding"].pull(kb)
        if not np.array_equal(v_r, v_o):
            return {"scenario": "shard_kill", "ok": False,
                    "detail": "post-restart pull diverged"}
        g = _grads(rng, kb, conf.pull_dim)
        remote["embedding"].push(kb, g)
        oracle["embedding"].push(kb, g)
        for _ in range(2):
            step()
        remote.end_pass()
        oracle.end_pass()
        snap_r = remote["embedding"].merged_snapshot()
        snap_o = _oracle_snapshot(oracle["embedding"])
        if not _snapshots_equal(snap_r, snap_o):
            return {"scenario": "shard_kill", "ok": False,
                    "detail": "final state diverged from the "
                              "never-killed oracle: updates were lost"}
        unavail = reg.counter("ps.remote.shard_unavailable").get()
        restarts = reg.counter("ps.remote.shard_restarts").get()
        retries = reg.counter("ps.remote.retries").get()
        client.close()
    steps.append(f"restart {restart_s:.2f}s resumed={resumed} "
                 f"zero-lost-updates rows={snap_o['keys'].size} counters: "
                 f"unavailable={unavail} restarts={restarts} "
                 f"retries={retries}")
    ok = unavail >= 1 and restarts == 1 and retries >= 1
    return {"scenario": "shard_kill", "ok": ok,
            "numbers": {"surfaced_s": surfaced, "restart_s": restart_s,
                        "rows": int(snap_o["keys"].size)},
            "detail": "; ".join(steps)}


def scenario_slow_shard(seed: int, root: str) -> Dict:
    """A shard answering seconds late costs one deadline and retry budget,
    never a wedged trainer; the healthy shard keeps serving."""
    conf = _table_conf(seed)
    rng = np.random.default_rng(seed)
    reg = MetricsRegistry()
    deadline_s = 0.4
    with ShardService({"embedding": conf}, num_shards=2,
                      spec_overrides={1: {"delay_s": 3.0}},
                      registry=reg) as svc:
        client = svc.client(deadline_s=deadline_s, retries=1)
        remote = RemoteTable(conf, client, cache_rows=0)
        pool = rng.integers(1, 2000, 1200).astype(np.uint64)
        remote.feed_pass(pool)     # a control op: not delayed
        sid = shard_of(pool, 2)
        mixed = pool[:256]
        only_fast = pool[sid == 0][:128]
        if not only_fast.size:
            return {"scenario": "slow_shard", "ok": False,
                    "detail": "seed produced no shard-0 keys"}
        t0 = time.monotonic()
        try:
            remote.pull(mixed)
            return {"scenario": "slow_shard", "ok": False,
                    "detail": "pull through the slow shard did not "
                              "expire"}
        except ShardUnavailable as e:
            surfaced = time.monotonic() - t0
            if e.shard != 1:
                return {"scenario": "slow_shard", "ok": False,
                        "detail": f"wrong shard blamed: {e}"}
        # the first attempt and one retry, each within the deadline, and
        # backoff slack: near the 3 s sleep means no deadline cut in
        budget = deadline_s * 2 + 1.0
        if surfaced > budget:
            return {"scenario": "slow_shard", "ok": False,
                    "detail": f"ShardUnavailable took {surfaced:.2f}s "
                              f"(> {budget:.2f}s): trainer was wedged"}
        t1 = time.monotonic()
        vals = remote.pull(only_fast)
        fast_ms = (time.monotonic() - t1) * 1e3
        if vals.shape != (only_fast.size, conf.pull_dim):
            return {"scenario": "slow_shard", "ok": False,
                    "detail": "healthy shard returned a bad shape"}
        client.close()
    return {"scenario": "slow_shard", "ok": True,
            "detail": f"expiry surfaced in {surfaced:.2f}s "
                      f"(deadline {deadline_s}s x2 + slack); healthy "
                      f"shard answered in {fast_ms:.0f}ms"}


def scenario_cache_wall(seed: int, root: str) -> Dict:
    """Coalesced head/tail replay against the service, cache off and on in
    pairs: the cached pulls' mean must be lower and their hit rate at
    least 0.5. Rows are 128 wide, so the payload is the cost cached away."""
    conf = TableConfig(embedx_dim=125, cvm_offset=3, optimizer="adam",
                       embedx_threshold=0.0, seed=seed)
    n_keys = 50_000
    hot_keys = 12_288
    cache_rows = 16384
    batch = 4096
    n_batches = 30
    rng = np.random.default_rng(seed)
    reg = MetricsRegistry()
    with ShardService({"embedding": conf}, num_shards=2,
                      registry=reg) as svc:
        client = svc.client(deadline_s=30.0, retries=1)
        plain = RemoteTable(conf, client, cache_rows=0)
        cached = RemoteTable(conf, client, cache_rows=cache_rows)
        keys = np.arange(1, n_keys + 1, dtype=np.uint64)
        for i in range(0, n_keys, 10_000):
            chunk = keys[i:i + 10_000]
            plain.feed_pass(chunk)
            g = np.zeros((chunk.size, conf.pull_dim), np.float32)
            g[:, 0] = 5.0
            plain.push(chunk, g)

        def coalesced_batch() -> np.ndarray:
            head = rng.choice(keys[:hot_keys], int(batch * 0.95),
                              replace=False)
            tail = rng.choice(keys[hot_keys:], batch - head.size,
                              replace=False)
            out = np.concatenate([head, tail])
            rng.shuffle(out)
            return out

        batches = [coalesced_batch() for _ in range(n_batches)]
        for b in batches[:3]:          # connections and allocator warm
            plain.pull(b, create=False)
        for _ in range(2):             # the cache to its steady state
            for b in batches:
                cached.pull(b, create=False)
        c = cached._cache
        h0, m0 = c.hits, c.misses
        lat_off: List[float] = []
        lat_on: List[float] = []
        mark = reg.counter("ps.remote.bytes_in").get()
        bytes_off = bytes_on = 0
        for _ in range(4):
            for b in batches:
                t0 = time.perf_counter()
                plain.pull(b, create=False)
                t1 = time.perf_counter()
                mid = reg.counter("ps.remote.bytes_in").get()
                bytes_off += mid - mark
                cached.pull(b, create=False)
                t2 = time.perf_counter()
                mark = reg.counter("ps.remote.bytes_in").get()
                bytes_on += mark - mid
                lat_off.append((t1 - t0) * 1e3)
                lat_on.append((t2 - t1) * 1e3)
        hit_rate = (c.hits - h0) / max((c.hits - h0) + (c.misses - m0),
                                       1)
        client.close()
    lat_off_a = np.array(lat_off)
    lat_on_a = np.array(lat_on)
    mean_off = float(lat_off_a.mean())
    mean_on = float(lat_on_a.mean())
    paired_delta_ms = float(np.median(lat_off_a - lat_on_a))
    numbers = {
        "hit_rate": hit_rate, "mean_off_ms": mean_off,
        "mean_on_ms": mean_on, "paired_delta_ms": paired_delta_ms,
        "p99_off_ms": float(np.percentile(lat_off_a, 99)),
        "p99_on_ms": float(np.percentile(lat_on_a, 99)),
        "bytes_off_per_replay": int(bytes_off // 4),
        "bytes_on_per_replay": int(bytes_on // 4),
    }
    ok = mean_on < mean_off and paired_delta_ms > 0.0 and hit_rate >= 0.5
    return {"scenario": "cache_wall", "ok": ok, "numbers": numbers,
            "detail": f"mean {mean_off:.3f}ms -> {mean_on:.3f}ms paired "
                      f"median delta {paired_delta_ms:+.3f}ms p99 "
                      f"{numbers['p99_off_ms']:.3f} -> "
                      f"{numbers['p99_on_ms']:.3f}ms hit_rate="
                      f"{hit_rate:.4f} wire bytes/replay "
                      f"{numbers['bytes_off_per_replay']} -> "
                      f"{numbers['bytes_on_per_replay']}"}


SCENARIOS = {
    "parity": scenario_parity,
    "shard_kill": scenario_shard_kill,
    "slow_shard": scenario_slow_shard,
    "cache_wall": scenario_cache_wall,
}


def run_scenario(name: str, seed: int, root: str,
                 deadline: Optional[float] = None) -> Dict:
    """One scenario under a hard wall-clock deadline."""
    if deadline is None:
        deadline = SCENARIO_DEADLINES.get(name, SCENARIO_DEADLINE)
    os.makedirs(root, exist_ok=True)
    result: List[Dict] = []

    def work():
        try:
            result.append(SCENARIOS[name](seed, root))
        except BaseException as e:  # noqa: BLE001 - report, not raise
            result.append({"scenario": name, "ok": False,
                           "detail": f"unexpected {type(e).__name__}: "
                                     f"{e}"})

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout=deadline)
    if not result:
        return {"scenario": name, "ok": False,
                "detail": f"deadline exceeded ({deadline:.0f}s): hung"}
    return result[0]


def run_drill(seed: int = 0, scenarios: Optional[List[str]] = None,
              workdir: Optional[str] = None,
              keep: bool = False) -> List[Dict]:
    names = list(scenarios) if scenarios else list(SCENARIOS)
    top = workdir or tempfile.mkdtemp(prefix="pbxt-ps-drill-")
    reports = []
    try:
        for i, name in enumerate(names):
            reports.append(run_scenario(name, seed + i,
                                        os.path.join(top, name)))
    finally:
        if not keep:
            shutil.rmtree(top, ignore_errors=True)
    return reports


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", action="append",
                    choices=list(SCENARIOS),
                    help="run only this scenario (repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)
    reports = run_drill(seed=args.seed, scenarios=args.scenario,
                        workdir=args.workdir, keep=args.keep)
    ok = True
    for rep in reports:
        status = "OK  " if rep["ok"] else "FAIL"
        print(f"[{status}] {rep['scenario']}: {rep['detail']}")
        ok = ok and rep["ok"]
    print(f"ps drill: {sum(r['ok'] for r in reports)}/{len(reports)} "
          f"scenarios ok")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
