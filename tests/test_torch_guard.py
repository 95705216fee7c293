"""The port's train guard (``paddlebox_tpu_torch/trainer/guard.py``) held
against the reference's (``paddlebox_tpu/trainer/guard.py``) on the CPU.

Both worlds are the reference's ``tools/guard_drill.py`` world (Wide&Deep
with hidden (8,), a 4096-row native one-thread table, a committed base with
its dense snapshot), the port's built from the reference's weights. Before
each case both restore that base (``ckpt/discovery.py``, as a rollback
does), so they start from the same bytes, and the same seeded batches go
through both guards under the same policy. Each case compares the trips
(``TripInfo`` field for field, the value within 1e-4 relative), the
``guard.*`` counters, the heartbeat ``guard`` records by event, and the
final dense params within 1e-5 (the table too, by key). The port is also
held to itself: guard on against guard off, bit for bit.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import make_slot_file
from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.ckpt import discovery as ref_discovery
from paddlebox_tpu.obs.metrics import REGISTRY as REF_REGISTRY
from paddlebox_tpu.trainer import guard as ref_guard
from paddlebox_tpu.utils import faults as ref_faults
from paddlebox_tpu_torch.ckpt import discovery
from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                        TableConfig, TrainerConfig)
from paddlebox_tpu_torch.data.batch import CsrBatch
from paddlebox_tpu_torch.metrics.auc import reset_auc_state_
from paddlebox_tpu_torch.models.convert import (flax_leaves_from_model,
                                                widedeep_from_flax_leaves)
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.trainer import guard
from paddlebox_tpu_torch.trainer.pass_manager import PassManager
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
from paddlebox_tpu_torch.utils import faults

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import guard_drill as drill  # noqa: E402

COUNTERS = ("guard.trips", "guard.trips_nan", "guard.trips_loss_spike",
            "guard.trips_auc_collapse", "guard.rollbacks",
            "guard.escalations", "guard.retries", "guard.skipped_steps",
            "guard.quarantined_steps")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_feed_conf() -> DataFeedConfig:
    return DataFeedConfig(
        slots=[SlotConfig("label", type="float", is_dense=True, dim=1),
               SlotConfig("slot_a"), SlotConfig("slot_b"),
               SlotConfig("dense_x", type="float", is_dense=True, dim=3)],
        batch_size=drill.B, label_slot="label", thread_num=1)


def port_table_conf() -> TableConfig:
    c = drill._table_conf()
    return TableConfig(embedx_dim=c.embedx_dim, cvm_offset=c.cvm_offset,
                       optimizer=c.optimizer,
                       learning_rate=c.learning_rate,
                       embedx_threshold=c.embedx_threshold, seed=c.seed)


class Batches:
    def __init__(self, batches):
        self._batches = batches

    def batches(self):
        return iter(self._batches)


class _NullDataset:
    def release_memory(self) -> None:
        pass


def port_batch(b) -> CsrBatch:
    return CsrBatch(keys=b.keys, segment_ids=b.segment_ids,
                    lengths=b.lengths, labels=b.labels, dense=b.dense,
                    batch_size=b.batch_size, num_slots=b.num_slots,
                    num_keys=b.num_keys, num_rows=b.num_rows)


def port_trainer(leaves):
    table = DeviceTable(port_table_conf(), capacity=4096, device="cpu",
                        backend="native", index_threads=1)
    return CTRTrainer(widedeep_from_flax_leaves(leaves, (8,)),
                      port_feed_conf(), port_table_conf(), TrainerConfig(),
                      table=table)


def restore_ref(tr, pm):
    plan = ref_discovery.latest_committed(pm.save_root)
    ref_discovery.apply_plan(pm.ps, plan)
    tr.params, tr.opt_state = ref_discovery.load_dense(
        plan, (tr.params, tr.opt_state))
    tr.auc_state = tr.step.init_auc_state()
    tr.reset_metrics()


def restore_port(tr, pm):
    plan = discovery.latest_committed(pm.save_root)
    discovery.apply_plan(pm.ps, plan)
    discovery.load_dense(plan, (tr.params, tr.opt_state))
    reset_auc_state_(tr.auc_state)
    tr.reset_metrics()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's drill world and the port's over the same committed
    base (the reference's root: both packages read either's trail)."""
    root = str(tmp_path_factory.mktemp("guard") / "ckpt")
    rtr, rpm, _ = drill._world(root, 0, index_threads=1)
    ptr = port_trainer([np.asarray(x) for x in
                        jax.tree_util.tree_leaves(rtr.params)])
    ppm = PassManager(SparsePS({"embedding": ptr.table}), root,
                      [_NullDataset()])
    yield (rtr, rpm), (ptr, ppm)
    ppm.close()
    rpm.close()


@pytest.fixture
def fresh(worlds, tmp_path, monkeypatch):
    """Both worlds restored to the base, each heartbeat to its own file."""
    (rtr, rpm), (ptr, ppm) = worlds
    restore_ref(rtr, rpm)
    restore_port(ptr, ppm)
    hb = {"ref": str(tmp_path / "ref.jsonl"),
          "port": str(tmp_path / "port.jsonl")}
    ref_flags.set("obs_heartbeat_path", hb["ref"])
    monkeypatch.setenv("PBOX_FLAGS_obs_heartbeat_path", hb["port"])
    yield (rtr, rpm), (ptr, ppm), hb
    ref_flags.set("obs_heartbeat_path", "")


def guard_records(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["hb"] == "guard"]


def counters(registry):
    return {n: registry.counter(n).get() for n in COUNTERS}


def run_both(fresh, batches, policy_kw, drive, *args):
    """``drive(package, guard, trainer, data, *args)`` for both packages
    under one policy over the same batches; returns each side's counter
    deltas, guard records and outcome."""
    (rtr, rpm), (ptr, ppm), hb = fresh
    out = {}
    for name, mod, tr, pm, reg, data in (
            ("ref", ref_guard, rtr, rpm, REF_REGISTRY, Batches(batches)),
            ("port", guard, ptr, ppm, REGISTRY,
             Batches([port_batch(b) for b in batches]))):
        before = counters(reg)
        g = mod.TrainGuard(tr, pass_manager=pm,
                           policy=mod.GuardPolicy(**policy_kw)).attach()
        try:
            result = drive(name, g, tr, data, *args)
        finally:
            g.detach()
        after = counters(reg)
        out[name] = dict(counters={k: after[k] - before[k] for k in after},
                         records=guard_records(hb[name]), result=result)
    return out


def strip(rec):
    """A guard record without what differs by run (time, pid, wall)."""
    return {k: v for k, v in rec.items()
            if k not in ("ts", "pid", "wall_s", "value", "detail",
                         "error")}


def assert_same_guard(out):
    ref, port = out["ref"], out["port"]
    assert port["counters"] == ref["counters"]
    assert [strip(r) for r in port["records"]] == \
        [strip(r) for r in ref["records"]]
    for a, b in zip(port["records"], ref["records"]):
        if "value" in b:
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-4)
            # the detail's text up to its first number (the numbers are
            # the values, compared above)
            assert a["detail"].split(" ")[0] == b["detail"].split(" ")[0]


def assert_same_model(worlds_pair, atol=1e-5):
    (rtr, _), (ptr, _) = worlds_pair[:2]
    ref_leaves = [np.asarray(x) for x in
                  jax.tree_util.tree_leaves(rtr.params)]
    port_leaves = flax_leaves_from_model(ptr.params)
    assert len(ref_leaves) == len(port_leaves)
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)
    jt, pt = rtr.table, ptr.table
    rk = jt._index.dump_keys(jt._size)
    pk = pt.row_keys()
    np.testing.assert_array_equal(np.sort(rk[1:]), np.sort(pk[1:]))
    ro, po = np.argsort(rk[1:]) + 1, np.argsort(pk[1:]) + 1
    np.testing.assert_allclose(pt.values.numpy()[po],
                               np.asarray(jt.values)[ro],
                               rtol=1e-5, atol=atol)


def run_pass(_name, g, _tr, data):
    return g.run_pass(data)


def plain_pass(_name, _g, tr, data):
    """The trainer's own pass with the guard attached (no executor)."""
    try:
        tr.train_from_dataset(data)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__
    return "finished"


def guarded_abort(_name, g, _tr, data):
    try:
        g.run_pass(data)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__
    return "finished"


def test_nan_rollback_matches_reference(fresh):
    rng = np.random.default_rng(5)
    batches = [drill.make_batch(rng) for _ in range(10)]
    batches[5] = drill.make_batch(rng, poison="nan")
    out = run_both(fresh, batches, dict(on_nan="rollback", lag=2,
                                        quarantine_window=2,
                                        max_rollbacks=2), run_pass)
    assert_same_guard(out)
    assert out["port"]["counters"]["guard.rollbacks"] == 1
    events = [r["event"] for r in out["port"]["records"]]
    assert events == ["trip", "rollback", "pass"]
    trip = out["port"]["records"][0]
    assert (trip["detector"], trip["step"], trip["window"]) == \
        ("nan", 5, [5, 7])
    for side in ("ref", "port"):
        np.testing.assert_allclose(out[side]["result"]["auc"],
                                   out["ref"]["result"]["auc"], rtol=1e-5)
    assert_same_model(fresh)
    (_, _), (ptr, _), _ = fresh
    assert all(torch.isfinite(p).all() for p in ptr.params.parameters())


def test_rollback_replay_equals_restored_twin(fresh):
    """The rolled-back model is bit for bit a twin restored from the same
    base and trained on the batches outside the quarantined window."""
    (_, _), (ptr, ppm), _ = fresh
    rng = np.random.default_rng(6)
    batches = [port_batch(drill.make_batch(rng)) for _ in range(8)]
    batches[3] = port_batch(drill.make_batch(rng, poison="nan"))
    g = guard.TrainGuard(ptr, pass_manager=ppm, policy=guard.GuardPolicy(
        on_nan="rollback", lag=1, quarantine_window=2)).attach()
    try:
        g.run_pass(Batches(batches))
    finally:
        g.detach()
    got = [p.detach().clone() for p in ptr.params.parameters()]
    got_rows = ptr.table.values.clone()
    restore_port(ptr, ppm)
    ptr.train_from_dataset(Batches(batches[:3] + batches[5:]))
    assert all(torch.equal(a, b) for a, b in zip(
        got, ptr.params.parameters()))
    assert torch.equal(got_rows, ptr.table.values)


def test_loss_spike_skip_matches_reference(fresh, tmp_path, monkeypatch):
    qdir = str(tmp_path / "quarantine")
    ref_flags.set("ingest_quarantine_dir", qdir + "-ref")
    monkeypatch.setenv("PBOX_FLAGS_ingest_quarantine_dir", qdir)
    try:
        rng = np.random.default_rng(7)
        batches = [drill.make_batch(rng) for _ in range(12)]
        batches[7] = drill.make_batch(rng, poison="loss")
        out = run_both(fresh, batches, dict(
            on_loss_spike="skip", lag=1, quarantine_window=2,
            loss_warmup=4, loss_z=6.0), run_pass)
    finally:
        ref_flags.set("ingest_quarantine_dir", "")
    assert_same_guard(out)
    assert [r["event"] for r in out["port"]["records"]] == \
        ["trip", "skip", "pass"]
    assert out["port"]["counters"]["guard.skipped_steps"] == 2
    sidecars = {}
    for side, d in (("ref", qdir + "-ref"), ("port", qdir)):
        (name,) = os.listdir(d)
        assert name.startswith("quarantine-guard-")
        with open(os.path.join(d, name)) as f:
            sidecars[side] = [{k: v for k, v in json.loads(x).items()
                               if k not in ("ts", "value", "detail")}
                              for x in f]
    assert sidecars["port"] == sidecars["ref"]
    assert sidecars["port"][0]["window"] == [7, 9]
    assert_same_model(fresh)


def test_auc_collapse_matches_reference(fresh):
    """Two clean passes build the baseline; a third whose drop passes the
    threshold trips (``auc_drop`` -1: any pass does), under skip."""
    rng = np.random.default_rng(8)
    passes = [[drill.make_batch(rng) for _ in range(4)] for _ in range(3)]

    def three(_name, g, _tr, data_unused, passes):
        conv = (lambda b: b) if _name == "ref" else port_batch
        return [g.run_pass(Batches([conv(b) for b in p]))["auc"]
                for p in passes]

    out = run_both(fresh, passes[0], dict(
        on_auc_collapse="skip", auc_drop=-1.0, auc_min_history=2),
        three, passes)
    assert_same_guard(out)
    assert [r["event"] for r in out["port"]["records"]] == \
        ["pass", "pass", "trip", "quarantine_only"]
    assert out["port"]["records"][2]["detector"] == "auc_collapse"
    np.testing.assert_allclose(out["port"]["result"],
                               out["ref"]["result"], rtol=1e-5)
    assert_same_model(fresh)


def test_check_nan_inf_aborts_like_reference(fresh, monkeypatch):
    """The flag's guard (``maybe_auto_guard``) aborts a plain pass whose
    last batch is poisoned: the lag would leave it unread, the pass end's
    flush finds it."""
    (rtr, _), (ptr, _), hb = fresh
    ref_flags.set("check_nan_inf", True)
    monkeypatch.setenv("PBOX_FLAGS_check_nan_inf", "1")
    rng = np.random.default_rng(9)
    batches = [drill.make_batch(rng) for _ in range(5)]
    batches[-1] = drill.make_batch(rng, poison="nan")
    out = {}
    try:
        for name, mod, tr, reg, data in (
                ("ref", ref_guard, rtr, REF_REGISTRY, Batches(batches)),
                ("port", guard, ptr, REGISTRY,
                 Batches([port_batch(b) for b in batches]))):
            before = counters(reg)
            g = mod.maybe_auto_guard(tr)
            assert g is not None and g.policy.action_for("nan") == "abort"
            try:
                result = plain_pass(name, g, tr, data)
            finally:
                g.detach()
            after = counters(reg)
            out[name] = dict(
                counters={k: after[k] - before[k] for k in after},
                records=guard_records(hb[name]), result=result)
    finally:
        ref_flags.set("check_nan_inf", False)
    assert_same_guard(out)
    assert out["port"]["result"] == out["ref"]["result"] == "GuardAbort"
    assert [r["event"] for r in out["port"]["records"]] == \
        ["trip", "escalate"]
    assert out["port"]["records"][0]["step"] == 4


def test_max_rollbacks_escalates_like_reference(fresh):
    rng = np.random.default_rng(10)
    batches = [drill.make_batch(rng, poison="nan") for _ in range(6)]
    out = run_both(fresh, batches, dict(on_nan="rollback", lag=1,
                                        quarantine_window=1,
                                        max_rollbacks=2), guarded_abort)
    assert_same_guard(out)
    assert out["port"]["result"] == out["ref"]["result"] == "GuardAbort"
    assert out["port"]["counters"]["guard.rollbacks"] == 2
    assert [r["event"] for r in out["port"]["records"]] == \
        ["trip", "rollback", "trip", "rollback", "trip", "escalate"]


def test_transient_retry_matches_reference(fresh):
    """A seeded injector fails the ``trainer.step`` io_point in both
    packages alike; the retries absorb every failure and each batch trains
    once."""
    rng = np.random.default_rng(11)
    batches = [drill.make_batch(rng) for _ in range(10)]

    def injected(name, g, tr, data):
        mod = ref_faults if name == "ref" else faults
        mod.install_injector(mod.FaultInjector(
            3, fail_rate=0.5, ops=("trainer.step",), max_failures=3))
        try:
            return g.run_pass(data)
        finally:
            mod.install_injector(None)

    out = run_both(fresh, batches, dict(step_retries=4), injected)
    assert_same_guard(out)
    assert out["port"]["counters"]["guard.retries"] == 3
    assert out["port"]["result"]["ins_num"] == 10 * drill.B
    assert_same_model(fresh)


def test_transient_set_is_oserror_only():
    assert guard.TrainGuard._TRANSIENT == (OSError,)
    assert issubclass(guard.GuardTripped, BaseException) and \
        not issubclass(guard.GuardTripped, Exception)


def test_guard_on_equals_guard_off(worlds, tmp_path):
    """A guard that never trips changes nothing: train_from_dataset and
    train_from_files, each against a twin without a guard, bit for bit."""
    (_, _), (ptr, ppm) = worlds
    rng = np.random.default_rng(12)
    batches = [port_batch(drill.make_batch(rng)) for _ in range(12)]
    conf = port_feed_conf()
    files = [make_slot_file(str(tmp_path / f"part-{i}"), conf, 40, seed=i)
             for i in range(2)]
    results = []
    for with_guard in (True, False):
        restore_port(ptr, ppm)
        g = (guard.TrainGuard(ptr, policy=guard.GuardPolicy(lag=2))
             .attach() if with_guard else None)
        try:
            m = [ptr.train_from_dataset(Batches(batches)),
                 ptr.train_from_files(files)]
        finally:
            if g is not None:
                g.detach()
        results.append((m, [p.detach().clone()
                            for p in ptr.params.parameters()],
                        ptr.table.values.clone(), ptr.table.state.clone()))
        if g is not None:
            assert g.lags and max(g.lags) >= 0
    (m1, p1, v1, s1), (m2, p2, v2, s2) = results
    assert m1 == m2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert torch.equal(v1, v2) and torch.equal(s1, s2)


def _parse_workers():
    """Live parse workers of this process (``/proc``: children running
    ``_mp_worker_main``)."""
    me, out = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z" and \
                b"_mp_worker_main" in cmd:
            out.append(int(pid))
    return out


def test_abort_mid_files_pass_leaves_nothing_running(tmp_path,
                                                     monkeypatch):
    """``check_nan_inf``'s guard stops a staged ``train_from_files`` pass
    over two parse workers at a NaN label: ``GuardAbort`` reaches the
    caller, and no ring slot, producer thread, parse worker or
    shared-memory segment is left."""
    import threading
    from paddlebox_tpu_torch.data import shm_fabric
    from paddlebox_tpu_torch.models import DeepFM
    conf = port_feed_conf()
    files = [make_slot_file(str(tmp_path / f"part-{i}"), conf, 48, seed=i)
             for i in range(2)]
    with open(files[1]) as f:
        lines = f.readlines()
    lines[20] = "1 nan " + lines[20].split(" ", 2)[2]
    with open(files[1], "w") as f:
        f.writelines(lines)
    monkeypatch.setenv("PBOX_FLAGS_check_nan_inf", "1")
    monkeypatch.setenv("PBOX_FLAGS_feed_device_prefetch", "2")
    table = DeviceTable(port_table_conf(), capacity=1024, device="cpu",
                        backend="native", index_threads=1)
    tr = CTRTrainer(DeepFM(2 * 7 + 3, (8,)), conf, port_table_conf(),
                    TrainerConfig(), table=table)
    assert tr._guard is not None
    with pytest.raises(guard.GuardAbort) as e:
        tr.train_from_files(files, workers=2)
    tr._guard.detach()
    assert e.value.trip.kind == "nan" and e.value.trip.step == 8
    assert tr._feed.ring.held == 0 and not tr._feed.producing
    assert not [t for t in threading.enumerate()
                if t.name == "device-feed" and t.is_alive()]
    assert not _parse_workers()
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(
        f"{shm_fabric.PREFIX}{os.getpid()}_")]
