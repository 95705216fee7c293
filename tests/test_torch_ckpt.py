"""Port's checkpoint subsystem (``paddlebox_tpu_torch/ckpt``,
``trainer/donefile.py``) and ``DeviceTable``'s delta protocol against the
JAX package's, on the CPU: the same files and dirs written and verified
across the packages, the same donefile records and torn-line handling, the
same restore plans and retention plans, the writer's error contract, the
dense state's leaf order, and the dirty rows of a table after each event
that marks or clears them, by key.

Arrays written by one package and read by the other are compared exactly
(the same bytes); nothing here trains, so there is no float tolerance."""

import json
import os
import shutil
import threading
import warnings

import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.ckpt import atomic as ref_atomic
from paddlebox_tpu.ckpt import discovery as ref_discovery
from paddlebox_tpu.ckpt import faults as ref_faults
from paddlebox_tpu.ckpt import retention as ref_retention
from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.trainer import donefile as ref_donefile
from paddlebox_tpu.trainer.train_step import \
    make_dense_optimizer as jax_dense_optimizer
from paddlebox_tpu.utils.checkpoint import pytree_arrays
from paddlebox_tpu_torch.ckpt import atomic, discovery, faults, retention
from paddlebox_tpu_torch.ckpt.writer import AsyncCheckpointWriter
from paddlebox_tpu_torch.config import BucketSpec, TableConfig, TrainerConfig
from paddlebox_tpu_torch.models import DeepFM, WideDeep
from paddlebox_tpu_torch.models.convert import (flax_leaves_from_deepfm,
                                                flax_leaves_from_widedeep,
                                                flax_order)
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.trainer import donefile
from paddlebox_tpu_torch.trainer.train_step import make_dense_optimizer
from paddlebox_tpu_torch.utils.checkpoint import dense_arrays, load_dense

ARRAYS = {"keys": np.arange(1, 9, dtype=np.uint64),
          "values": np.linspace(0, 1, 24, dtype=np.float32).reshape(8, 3)}


@pytest.fixture(autouse=True)
def disarmed():
    yield
    faults.disarm_all()
    ref_faults.disarm_all()


def committed_dir(mod, root, name="d"):
    """A dir committed by ``mod`` (either package's ``atomic``) holding
    two npz files and a nested one."""
    final = os.path.join(root, name)
    staging = mod.stage_dir(final)
    mod.write_npz(os.path.join(staging, "table.npz"), ARRAYS)
    mod.write_npz(os.path.join(staging, "dense.npz"),
                  {"leaf_00000": np.ones(3, np.float32)})
    os.makedirs(os.path.join(staging, "sub"))
    mod.write_npz(os.path.join(staging, "sub", "x.npz"), ARRAYS)
    mod.commit_dir(staging, final)
    return final


# -- atomic ------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_committed_dir_verifies_in_both_packages(tmp_path, writer):
    mod = atomic if writer == "port" else ref_atomic
    final = committed_dir(mod, str(tmp_path))
    with open(os.path.join(final, atomic.MANIFEST)) as f:
        manifest = json.load(f)
    assert manifest["algo"] == atomic.CRC_ALGO == ref_atomic.CRC_ALGO
    assert [e["name"] for e in manifest["files"]] == \
        ["dense.npz", "sub/x.npz", "table.npz"]
    atomic.verify(final, require_manifest=True)
    ref_atomic.verify(final, require_manifest=True)
    assert not [p for p in os.listdir(tmp_path) if ".tmp-" in p]
    with np.load(os.path.join(final, "table.npz")) as data:
        for k, v in ARRAYS.items():
            np.testing.assert_array_equal(data[k], v)


def test_manifest_is_the_references(tmp_path):
    """Both packages' manifests of the same artifacts are equal."""
    a = atomic.stage_dir(str(tmp_path / "a"))
    atomic.write_npz(os.path.join(a, "t.npz"), ARRAYS)
    b = str(tmp_path / "b")
    os.makedirs(b)
    with open(os.path.join(a, "t.npz"), "rb") as src, \
            open(os.path.join(b, "t.npz"), "wb") as dst:
        dst.write(src.read())
    assert atomic.write_manifest(a) == ref_atomic.write_manifest(b)


@pytest.mark.parametrize("damage", ["flip", "truncate", "delete",
                                    "manifest"])
def test_damage_fails_verification_in_both(tmp_path, damage):
    final = committed_dir(atomic, str(tmp_path))
    p = os.path.join(final, "table.npz")
    if damage == "flip":
        with open(p, "r+b") as f:
            f.seek(40)
            b = f.read(1)
            f.seek(40)
            f.write(bytes([b[0] ^ 0xFF]))
    elif damage == "truncate":
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) - 3)
    elif damage == "delete":
        os.unlink(p)
    else:
        with open(os.path.join(final, atomic.MANIFEST), "w") as f:
            f.write("{not json")
    with pytest.raises(atomic.IntegrityError):
        atomic.verify(final)
    with pytest.raises(ref_atomic.IntegrityError):
        ref_atomic.verify(final)
    assert not atomic.is_committed(final)


def test_unknown_algo_checks_sizes_only(tmp_path):
    final = committed_dir(atomic, str(tmp_path))
    mpath = os.path.join(final, atomic.MANIFEST)
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["algo"] = "xxh3"
    for e in manifest["files"]:
        e["crc"] = 0
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    atomic.verify(final)
    ref_atomic.verify(final)
    manifest["files"][0]["size"] += 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(atomic.IntegrityError, match="size mismatch"):
        atomic.verify(final)


def test_verify_without_manifest(tmp_path):
    d = tmp_path / "legacy"
    d.mkdir()
    atomic.verify(str(d))
    with pytest.raises(atomic.IntegrityError, match="no manifest"):
        atomic.verify(str(d), require_manifest=True)
    with pytest.raises(atomic.IntegrityError, match="missing"):
        atomic.verify(str(tmp_path / "absent"))


def test_commit_dir_replaces_an_existing_dir(tmp_path):
    final = committed_dir(atomic, str(tmp_path))
    staging = atomic.stage_dir(final)
    atomic.write_npz(os.path.join(staging, "only.npz"), ARRAYS)
    atomic.commit_dir(staging, final)
    assert sorted(os.listdir(final)) == [atomic.MANIFEST, "only.npz"]
    assert os.listdir(tmp_path) == ["d"]


def test_atomic_file_cleans_up_errors_and_keeps_crash_spill(tmp_path):
    p = str(tmp_path / "f.npz")
    with pytest.raises(RuntimeError):
        with atomic.atomic_file(p) as f:
            f.write(b"x")
            raise RuntimeError("boom")
    assert os.listdir(tmp_path) == []
    with pytest.raises(faults.InjectedCrash):
        with atomic.atomic_file(p) as f:
            f.write(b"x")
            raise faults.InjectedCrash("delta.mid_write")
    (spill,) = os.listdir(tmp_path)
    assert spill.startswith("f.npz.tmp-")
    assert retention.prune_tmp(str(tmp_path)) == [str(tmp_path / spill)]
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("point", ["before_manifest", "after_manifest"])
def test_commit_crash_points_leave_no_committed_dir(tmp_path, point):
    final = str(tmp_path / "base")
    staging = atomic.stage_dir(final)
    atomic.write_npz(os.path.join(staging, "t.npz"), ARRAYS)
    faults.arm(f"base.{point}")
    with pytest.raises(faults.InjectedCrash):
        atomic.commit_dir(staging, final, scope="base")
    assert not os.path.exists(final)
    assert (os.path.exists(os.path.join(staging, atomic.MANIFEST))
            == (point == "after_manifest"))
    retention.prune_tmp(str(tmp_path))
    assert os.listdir(tmp_path) == []


# -- faults ------------------------------------------------------------------

def test_crash_points_are_the_references():
    assert set(faults.CRASH_POINTS) <= set(ref_faults.CRASH_POINTS)
    with pytest.raises(ValueError):
        faults.arm("base.nowhere")
    with pytest.raises(ValueError):
        faults.arm("base.mid_write", at_hit=0)
    with pytest.raises(ValueError):
        faults.crash_point("base.nowhere")
    faults.arm("delta.mid_write", at_hit=3)
    faults.crash_point("delta.mid_write")
    faults.crash_point("delta.mid_write")
    with pytest.raises(faults.InjectedCrash) as e:
        faults.crash_point("delta.mid_write")
    assert e.value.point == "delta.mid_write"
    faults.crash_point("delta.mid_write")      # disarmed after firing
    faults.arm("base.mid_write")
    faults.disarm_all()
    faults.crash_point("base.mid_write")
    assert not issubclass(faults.InjectedCrash, Exception)


# -- donefile ----------------------------------------------------------------

def fields(records, root):
    return [(r["kind"], r["day"], r["pass_id"],
             os.path.relpath(r["path"], root), r["size"]) for r in records]


def test_donefile_records_are_the_references(tmp_path):
    """The same appends in both packages give the same records, and each
    package reads the other's trail."""
    trails = {}
    for name, mod in (("port", donefile), ("ref", ref_donefile)):
        root = str(tmp_path / name)
        d = committed_dir(atomic, root, "20260101/00001/base")
        mod.write_done(root, "20260101", 1, "base", d)
        mod.write_done(root, 20260101, 2, "delta", d, extra={"note": 1})
        trails[name] = root
    for root in trails.values():
        assert fields(donefile.read_done(root), root) == \
            fields(ref_donefile.read_done(root), root)
    a, b = (donefile.read_done(r) for r in trails.values())
    assert fields(a, trails["port"]) == fields(b, trails["ref"])
    assert a[1]["note"] == b[1]["note"] == 1
    assert donefile.last_done(trails["port"], "delta")["pass_id"] == 2
    assert donefile.last_done(trails["port"], "dense") is None


def test_torn_tail_is_dropped_then_repaired_as_the_reference(tmp_path):
    """A crash mid-append (``donefile.mid_append``) leaves a torn last
    line: both packages read past it with a warning, the next append cuts
    it off, and both trails end equal."""
    roots = {}
    for name, mod, flt in (("port", donefile, faults),
                           ("ref", ref_donefile, ref_faults)):
        root = str(tmp_path / name)
        os.makedirs(root)
        mod.write_done(root, "d", 1, "base", root)
        flt.arm("donefile.mid_append")
        with pytest.raises(flt.InjectedCrash):
            mod.write_done(root, "d", 2, "delta", root)
        with pytest.warns(UserWarning, match="torn trailing"):
            assert len(mod.read_done(root)) == 1
        with pytest.warns(UserWarning, match="truncating torn tail"):
            mod.write_done(root, "d", 3, "delta", root)
        roots[name] = root
    for root in roots.values():
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            recs = donefile.read_done(root)
        assert [(r["kind"], r["pass_id"]) for r in recs] == \
            [("base", 1), ("delta", 3)]


def test_malformed_middle_line_raises_in_both(tmp_path):
    root = str(tmp_path)
    donefile.write_done(root, "d", 1, "base", root)
    with open(os.path.join(root, donefile.DONEFILE), "a") as f:
        f.write("{torn\n")
    donefile.write_done(root, "d", 2, "delta", root)
    with pytest.raises(ValueError, match="corrupt donefile"):
        donefile.read_done(root)
    with pytest.raises(ValueError, match="corrupt donefile"):
        ref_donefile.read_done(root)


def trail(root, layout):
    """Commit one dir per ``layout`` entry (kind, day, pass) and record
    it; returns the paths."""
    paths = []
    for kind, day, pid in layout:
        p = committed_dir(atomic, root, f"{day}/{pid:05d}/{kind}")
        donefile.write_done(root, day, pid, kind, p)
        paths.append(p)
    return paths


LAYOUT = [("base", "d1", 1), ("delta", "d1", 2), ("delta", "d1", 3),
          ("base", "d2", 4), ("delta", "d2", 5), ("delta", "d2", 6),
          ("delta", "d2", 7)]


def plans_of(cands, root):
    return [(os.path.relpath(b["path"], root),
             [os.path.relpath(d["path"], root) for d in ds])
            for b, ds in cands]


@pytest.mark.parametrize("lost", [None, 3, 5, 0])
def test_resume_candidates_match_the_reference(tmp_path, lost):
    """Plans over a trail whose dir ``lost`` vanished: a lost delta cuts
    its chain, a lost base is no candidate."""
    import shutil
    root = str(tmp_path)
    paths = trail(root, LAYOUT)
    if lost is not None:
        shutil.rmtree(paths[lost])
    got = plans_of(donefile.resume_candidates(root), root)
    assert got == plans_of(ref_donefile.resume_candidates(root), root)
    plan = donefile.resume_plan(root)
    assert plans_of([plan], root) == got[:1]
    want_latest = {None: 3, 3: 0, 5: 3, 0: 3}[lost]
    assert got[0][0] == os.path.relpath(paths[want_latest], root)
    if lost == 5:
        assert got[0][1] == [os.path.relpath(paths[4], root)]


# -- discovery ---------------------------------------------------------------

@pytest.mark.parametrize("bad", [None, 3, 5])
def test_verified_candidates_match_the_reference(tmp_path, bad):
    """A base that fails verification is skipped, a failing delta cuts its
    chain; the plan's version is its newest record's."""
    root = str(tmp_path)
    paths = trail(root, LAYOUT)
    if bad is not None:
        with open(os.path.join(paths[bad], "table.npz"), "ab") as f:
            f.write(b"x")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = plans_of(discovery.verified_candidates(root), root)
        want = plans_of(ref_discovery.verified_candidates(root), root)
        plan = discovery.latest_committed(root)
        ref_plan = ref_discovery.latest_committed(root)
    assert got == want
    assert discovery.plan_version(plan) == \
        ref_discovery.plan_version(ref_plan)
    assert discovery.plan_version(plan) == \
        {None: ("d2", 7), 3: ("d1", 3), 5: ("d2", 5)}[bad]
    assert discovery.latest_committed(str(tmp_path / "empty")) is None


# -- retention ---------------------------------------------------------------

RECORD_SETS = {
    "few": [("base", "a"), ("delta", "b")],
    "three-bases": [("base", "a"), ("delta", "b"), ("base", "c"),
                    ("delta", "d"), ("base", "e"), ("delta", "f")],
    "unknown-kind": [("base", "a"), ("dense", "x"), ("base", "c"),
                     ("delta", "a"), ("base", "e")],
}


@pytest.mark.parametrize("keep", [1, 2, 3])
@pytest.mark.parametrize("records", sorted(RECORD_SETS))
def test_retention_plan_matches_the_reference(records, keep):
    recs = [{"kind": k, "path": f"/r/{p}"} for k, p in RECORD_SETS[records]]
    keep_set, drop = retention.RetentionPolicy(keep).plan(recs)
    want = ref_retention.RetentionPolicy(keep).plan(recs)
    assert (keep_set, drop) == want
    with pytest.raises(ValueError):
        retention.RetentionPolicy(0)


def test_sweep_removes_old_chains_inside_the_root_only(tmp_path):
    root = str(tmp_path / "root")
    paths = trail(root, LAYOUT)
    outside = committed_dir(atomic, str(tmp_path), "outside")
    recs = donefile.read_done(root)
    recs.insert(0, {"kind": "base", "path": outside, "day": "d0",
                    "pass_id": 0})
    removed = retention.RetentionPolicy(1).sweep(root, recs)
    assert removed == paths[:3]
    assert os.path.isdir(outside)
    assert sorted(os.listdir(root)) == ["d2", donefile.DONEFILE]


def test_prune_tmp_removes_spill_only(tmp_path):
    root = tmp_path / "r"
    (root / "d1" / "00001" / "delta.tmp-1a2b-0123abcd").mkdir(parents=True)
    (root / "d1" / "00001" / "base").mkdir()
    (root / "d1" / "x.npz.tmp-ff-deadbeef").write_bytes(b"x")
    (root / "d1" / "keep.tmp-notspill").write_bytes(b"x")
    removed = retention.prune_tmp(str(root))
    assert sorted(os.path.basename(p) for p in removed) == \
        ["delta.tmp-1a2b-0123abcd", "x.npz.tmp-ff-deadbeef"]
    assert sorted(os.listdir(root / "d1")) == ["00001", "keep.tmp-notspill"]
    assert os.listdir(root / "d1" / "00001") == ["base"]
    assert retention.prune_tmp(str(tmp_path / "absent")) == []


# -- writer ------------------------------------------------------------------

def test_writer_runs_jobs_in_order_and_fences():
    w = AsyncCheckpointWriter(max_queue=1)
    gate, done = threading.Event(), []
    w.submit("hold", gate.wait)
    threading.Timer(0.05, gate.set).start()
    for i in range(3):
        # the queue holds one job: submit waits for the worker (backpressure)
        w.submit(f"j{i}", lambda i=i: done.append(i))
    w.barrier()
    assert done == [0, 1, 2] and w.pending() == 0 and w.alive()
    w.close()
    assert not w.alive()
    with pytest.raises(atomic.CheckpointError, match="closed"):
        w.submit("late", lambda: None)
    w.close()


def test_writer_retries_transient_errors():
    w = AsyncCheckpointWriter(retries=3, retry_delay=0.001)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")

    w.submit("flaky", flaky)
    w.barrier()
    assert len(calls) == 3
    w.close()


def test_writer_reports_a_failed_job_once_and_runs_on_fail():
    w = AsyncCheckpointWriter(retries=2, retry_delay=0.001)
    calls, rolled_back = [], []

    def broken():
        calls.append(1)
        raise OSError("disk full")

    w.submit("broken", broken, on_fail=lambda: rolled_back.append(1))
    with pytest.raises(atomic.CheckpointError, match="'broken' failed"):
        w.barrier()
    assert len(calls) == 2 and rolled_back == [1]
    w.raise_pending()                        # reported once
    w.submit("ok", lambda: None)
    w.barrier()
    w.submit("value", lambda: 1 / 0)
    with pytest.raises(atomic.CheckpointError, match="ZeroDivisionError"):
        w.barrier()
    w.close()


def test_writer_dies_on_an_injected_crash():
    w = AsyncCheckpointWriter(max_queue=1)

    def crash():
        raise faults.InjectedCrash("base.mid_write")

    w.submit("crash", crash)
    with pytest.raises(faults.InjectedCrash):
        w.barrier()
    assert not w.alive()
    with pytest.raises(atomic.CheckpointError, match="dead"):
        w.submit("after", lambda: None)
    w.close()


# -- dense state -------------------------------------------------------------

def trained_state(model, name, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    opt = make_dense_optimizer(TrainerConfig(dense_optimizer=name,
                                             dense_learning_rate=0.01))
    state = opt.init(model)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.from_numpy(
                rng.normal(size=tuple(p.shape)).astype(np.float32))
        state = opt.update(model, state)
    return state


@pytest.mark.parametrize("name", ["adam", "adagrad", "sgd"])
def test_dense_leaves_are_the_references_order(name):
    """``dense_arrays((model, opt_state))`` has the leaves of the
    reference's ``pytree_arrays((params, opt_state))``, the optimizer
    state stepped by optax on the same grads."""
    torch.manual_seed(0)
    model = DeepFM(12, (8, 4))
    leaves0 = flax_leaves_from_deepfm(model)
    jopt = jax_dense_optimizer(JaxTrainerConfig(dense_optimizer=name,
                                                dense_learning_rate=0.01))
    params = [np.asarray(x) for x in leaves0]
    jstate = jopt.init(params)
    rng = np.random.default_rng(0)
    order = list(model.parameters())
    slots = flax_order(model)
    opt = make_dense_optimizer(TrainerConfig(dense_optimizer=name,
                                             dense_learning_rate=0.01))
    state = opt.init(model)
    for _ in range(3):
        grads = [rng.normal(size=x.shape).astype(np.float32)
                 for x in params]
        for (j, kernel), g in zip(slots, grads):
            order[j].grad = torch.from_numpy(np.array(g.T if kernel
                                                      else g))
        state = opt.update(model, state)
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
    got = dense_arrays((model, state))
    want = pytree_arrays((params, jstate))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["deepfm", "widedeep"])
def test_dense_state_round_trips_in_place(tmp_path, kind):
    torch.manual_seed(1)
    make = (lambda: DeepFM(10, (6,))) if kind == "deepfm" else \
        (lambda: WideDeep(10, (6, 3)))
    model = make()
    state = trained_state(model, "adam")
    path = str(tmp_path / "dense.npz")
    atomic.write_npz(path, dense_arrays((model, state)))
    leaves = (flax_leaves_from_deepfm if kind == "deepfm"
              else flax_leaves_from_widedeep)(model)
    with np.load(path) as data:
        for i, x in enumerate(leaves):
            np.testing.assert_array_equal(data[f"leaf_{i:05d}"], x)
    fresh = make()
    fstate = make_dense_optimizer(TrainerConfig()).init(fresh)
    count, mu = fstate["count"], fstate["mu"]
    assert load_dense(path, (fresh, fstate))[1] is fstate
    assert fstate["count"] is count and fstate["mu"] is mu
    assert int(count) == 3
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    for f in ("mu", "nu"):
        for a, b in zip(fstate[f], state[f]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        load_dense(path, (DeepFM(11, (6,)) if kind == "deepfm" else
                          WideDeep(11, (6, 3)), fstate))
    with pytest.raises(ValueError, match="template"):
        load_dense(path, (fresh, {}))
    with pytest.raises(TypeError):
        dense_arrays(fresh)


def test_dense_arrays_are_copies():
    model = DeepFM(6, (4,))
    state = trained_state(model, "adam", steps=1)
    arrays = dense_arrays((model, state))
    before = {k: v.copy() for k, v in arrays.items()}
    trained_state(model, "adam", steps=1, seed=5)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        state["count"].add_(7)
    for k in before:
        np.testing.assert_array_equal(arrays[k], before[k])


# -- DeviceTable's delta protocol -------------------------------------------

CONF = dict(embedx_dim=4, show_clk_decay=0.5)


def tables(backend, capacity=16):
    """The reference's table and the port's, same config and arena."""
    kw = dict(backend=backend)
    if backend == "native":
        kw["index_threads"] = 1
    jt = JaxDeviceTable(JaxTableConfig(**CONF), capacity=capacity,
                        uniq_buckets=JaxBucketSpec(min_size=8), **kw)
    pt = DeviceTable(TableConfig(**CONF), capacity=capacity,
                     uniq_buckets=BucketSpec(min_size=8), device="cpu",
                     **kw)
    pt.load_arena(np.asarray(jt.values), np.asarray(jt.state),
                  jt._index.dump_keys(jt._size))
    return jt, pt


def dirty_keys(t):
    return np.sort(t._index.dump_keys(t._size)[t.fetch_dirty_rows()])


def assert_same_dirty(jt, pt):
    np.testing.assert_array_equal(dirty_keys(pt), dirty_keys(jt))


BACKENDS = ["numpy", pytest.param("native", marks=pytest.mark.skipif(
    not ref_native.available(), reason="native backend unavailable"))]


@pytest.mark.parametrize("backend", BACKENDS)
def test_dirty_rows_follow_the_reference(tmp_path, backend):
    """Marks by ``prepare_batch(create=True)`` (not without create),
    through a growth, cleared by ``snapshot_delta``, ``snapshot`` and
    ``load``, set by ``load_delta``; each snapshot and file equal to the
    reference's (values where both tables hold the same init: a growth
    draws new rows from each package's own generator)."""
    rng = np.random.default_rng(3)
    jt, pt = tables(backend)
    for step in range(4):
        keys = rng.integers(0, 40, size=30).astype(np.uint64)
        jt.prepare_batch(keys, create=step != 2)
        pt.prepare_batch(keys, create=step != 2)
        assert_same_dirty(jt, pt)
    assert pt.capacity == jt.capacity > 16           # grown
    assert 0 not in pt.fetch_dirty_rows()
    rows = pt.fetch_dirty_rows()
    jd, pd = jt.snapshot_delta(), pt.snapshot_delta()
    np.testing.assert_array_equal(pd["keys"], np.asarray(jd["keys"]))
    old = rows < 16
    for k in ("values", "state"):
        np.testing.assert_array_equal(pd[k][old], np.asarray(jd[k])[old],
                                      err_msg=k)
    assert pt.fetch_dirty_rows().size == 0
    # files, over tables that do not grow
    jt, pt = tables(backend, capacity=256)
    keys = rng.integers(1, 60, size=40).astype(np.uint64)
    paths = {}
    for tag, t in (("ref", jt), ("port", pt)):
        t.prepare_batch(keys)
        t.end_pass()
        paths[tag, "delta"] = str(tmp_path / f"{tag}.delta.npz")
        assert t.save_delta(paths[tag, "delta"]) == np.unique(keys).size
        t.prepare_batch(keys[:3])
        paths[tag, "base"] = str(tmp_path / f"{tag}.base.npz")
        t.save(paths[tag, "base"])
        assert t.fetch_dirty_rows().size == 0
    for kind in ("delta", "base"):
        with np.load(paths["ref", kind]) as a, \
                np.load(paths["port", kind]) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # each package's base, then the other's delta, into fresh tables: the
    # delta's rows dirty, nothing else
    jt2, pt2 = tables(backend, capacity=256)
    for t, base, delta in ((jt2, "ref", "port"), (pt2, "port", "ref")):
        t.load(paths[base, "base"])
        assert t.fetch_dirty_rows().size == 0
        t.load_delta(paths[delta, "delta"])
    assert_same_dirty(jt2, pt2)
    np.testing.assert_array_equal(dirty_keys(pt2), np.unique(keys))
    np.testing.assert_array_equal(pt2.values[:pt2._size].numpy(),
                                  np.asarray(jt2.values)[:jt2._size])


@pytest.mark.skipif(not ref_native.available(),
                    reason="native backend unavailable")
def test_insert_keys_and_the_device_bitmap():
    """Device prep's marks: ``insert_keys`` marks new rows on the host;
    the bitmap (made by ``enable_device_index``) is read by
    ``fetch_dirty_rows``, grows with the arena keeping its marks, and is
    cleared in place."""
    jt, pt = tables("native")
    jt.enable_device_index()
    pt.enable_device_index()
    bitmap = pt.dirty_dev
    assert bitmap.dtype == torch.bool and bitmap.shape == (16,)
    for t in (jt, pt):
        t.insert_keys(np.arange(1, 9, dtype=np.uint64))
        t.insert_keys(np.arange(5, 12, dtype=np.uint64))
    assert_same_dirty(jt, pt)
    pt.snapshot()
    jt.snapshot()
    assert pt.fetch_dirty_rows().size == jt.fetch_dirty_rows().size == 0
    # what a step's marks leave in each bitmap (row 0: padding)
    pt.dirty_dev[torch.tensor([3, 0])] = True
    jt.dirty_dev = jt.dirty_dev.at[np.array([3, 0])].set(True)
    assert_same_dirty(jt, pt)
    assert pt.dirty_dev is bitmap
    pt._clear_dirty()
    assert pt.dirty_dev is bitmap and not bitmap.any()
    pt.dirty_dev[5] = True
    pt.insert_keys(np.arange(100, 140, dtype=np.uint64))    # grows
    assert pt.capacity > 16 and pt.dirty_dev is not bitmap
    assert pt.dirty_dev.shape == (pt.capacity,) and bool(pt.dirty_dev[5])
    assert pt.fetch_dirty_rows().tolist() == [5] + list(range(12, 52))


def test_snapshot_is_a_copy_on_the_cpu():
    jt, pt = tables("numpy")
    pt.prepare_batch(np.arange(1, 6, dtype=np.uint64))
    snap = pt.snapshot()
    pt.prepare_batch(np.arange(1, 6, dtype=np.uint64))
    delta = pt.snapshot_delta()
    want = {k: v.copy() for k, v in (*snap.items(), *(
        ("d" + k, v) for k, v in delta.items()))}
    pt.values.add_(1.0)
    pt.state.add_(1.0)
    for k, v in (*snap.items(), *(("d" + k, v) for k, v in delta.items())):
        np.testing.assert_array_equal(v, want[k], err_msg=k)
