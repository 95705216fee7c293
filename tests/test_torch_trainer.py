"""Port's ``CTRTrainer.train_from_dataset`` (on the CPU, plain versions of
the kernels) against the JAX package's ``CTRTrainer`` on the same slot
files (``conftest.make_slot_file`` at the reference tests' ``feed_conf``:
3 sparse slots, a 3-wide dense slot, batch 8, two files of 48 rows), from
the same dense weights (the reference trainer's params, converted) and the
same arena (the reference table's ``values``, ``state`` and keys, carried
by ``load_arena``). Both tables are native with one index thread, so the
trainers resolve device prep on, and their capacity outlasts the pass, so
no arena grows (new keys take the preallocated rows both share).

Tolerances: per-batch loss and preds atol 1e-5; pass metrics ``ins_num``
exact, the rest atol 1e-5; dense params rtol 1e-4, atol 1e-6 (as
``test_torch_fused_step.py::test_five_steps_match_jax``); rows show/clk
exact, the rest atol 1e-5; dumped search_id and label exact, pred atol
1e-5. The reference trainers are built and run once per module."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from conftest import make_slot_file
from paddlebox_tpu.config import DataFeedConfig as JaxFeedConfig
from paddlebox_tpu.config import SlotConfig as JaxSlotConfig
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.data.dataset import SlotDataset as JaxSlotDataset
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.models import WideDeep as FlaxWideDeep
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu.utils.timer import SpanTimer as JaxSpanTimer
from paddlebox_tpu_torch.config import (DataFeedConfig, TableConfig,
                                        TrainerConfig, feed_prefetch_conf)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.obs import heartbeat as port_heartbeat
from paddlebox_tpu_torch.obs import postmortem as port_postmortem
from paddlebox_tpu_torch.obs import trace as port_trace
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_deepfm,
                                                flax_leaves_from_widedeep,
                                                widedeep_from_flax_leaves)
from paddlebox_tpu_torch.ops import (device_index_kernel, seqpool_kernel,
                                     sparse_push)
from paddlebox_tpu_torch.parallel.dp_step import ShardedTrainStep
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer import trainer as port_trainer
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
from paddlebox_tpu_torch.utils.timer import SpanTimer

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

HIDDEN = (16,)
TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.05, embedx_threshold=0.0, seed=2)
CAPACITY = 4096
STEPS = 12          # two files of 48 rows, batch 8
MODELS = {"deepfm": (FlaxDeepFM, deepfm_from_flax_leaves,
                     flax_leaves_from_deepfm),
          "widedeep": (FlaxWideDeep, widedeep_from_flax_leaves,
                       flax_leaves_from_widedeep)}
CUDA_WRAPPERS = (seqpool_kernel.seqpool_cvm_cuda,
                 seqpool_kernel.seqpool_cvm_grad_cuda,
                 sparse_push.sparse_push_cuda,
                 device_index_kernel.device_dedup_probe_cuda)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """JAX's CPU thread pools spin beside torch's intra-op threads and slow
    these small torch ops several times over; one thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_feed_conf():
    """The reference tests' ``feed_conf`` (tests/conftest.py)."""
    return JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=3),
    ], batch_size=8, label_slot="label", thread_num=2)


def port_feed_conf():
    return DataFeedConfig.from_dict(dataclasses.asdict(jax_feed_conf()))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer_slots")
    return [make_slot_file(str(d / f"part-{i}"), jax_feed_conf(), 48,
                           seed=i) for i in range(2)]


def port_dataset(files):
    ds = SlotDataset(port_feed_conf())
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds


def leaves_of(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def table_state(table_values, table_state_, keys, size):
    return dict(values=np.asarray(table_values)[:size].copy(),
                state=np.asarray(table_state_)[:size].copy(),
                keys=np.asarray(keys).copy(), size=size)


def run_reference(kind, files, dump_path, device_prep, num_devices=1):
    """The reference trainer over a native one-thread table: pass 1 (the
    default AUC drain, with a dump and a fetch handler), its evaluation,
    then pass 2 with ``AUC_DRAIN_STEPS`` = 4. Returns the initial weights
    and arena and what each phase gave. ``num_devices``: its
    ``TrainerConfig``'s."""
    flax_cls = MODELS[kind][0]
    jt = JaxDeviceTable(JaxTableConfig(**TABLE), capacity=CAPACITY,
                        backend="native", index_threads=1)
    arena = (np.asarray(jt.values).copy(), np.asarray(jt.state).copy(),
             jt._index.dump_keys(jt._size))
    tr = ref_trainer.CTRTrainer(
        flax_cls(hidden=HIDDEN), jax_feed_conf(), JaxTableConfig(**TABLE),
        JaxTrainerConfig(num_devices=num_devices), table=jt,
        dump_path=dump_path, device_prep=device_prep)
    assert tr.step.device_prep == (device_prep is not False)
    out = dict(init=leaves_of(tr.params), arena=arena)
    ds = JaxSlotDataset(jax_feed_conf())
    ds.set_filelist(files)
    ds.load_into_memory()
    for tag in ("pass1", "pass2"):
        fetched = []
        if tag == "pass2":
            tr.reset_metrics()
            ref_trainer.AUC_DRAIN_STEPS, saved = 4, ref_trainer.AUC_DRAIN_STEPS
        try:
            metrics = tr.train_from_dataset(
                ds, fetch_handler=lambda s, l, p: fetched.append(
                    (s, l, np.asarray(p).copy())))
        finally:
            if tag == "pass2":
                ref_trainer.AUC_DRAIN_STEPS = saved
        out[tag] = dict(
            metrics=metrics, fetched=fetched, params=leaves_of(tr.params),
            table=table_state(jt.values, jt.state,
                              jt._index.dump_keys(jt._size), jt._size),
            main=tr.timer.count["main"], step=tr.timer.count["step"])
        if tag == "pass1":
            tr.close_dump()
            out["dump"] = [json.loads(x) for x in open(dump_path)]
            out["eval"] = tr.evaluate(ds)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory, files):
    """Reference runs, each built on first use: (model, device_prep,
    num_devices)."""
    runs = {}

    def get(kind, device_prep=None, num_devices=1):
        key = (kind, device_prep, num_devices)
        if key not in runs:
            d = tmp_path_factory.mktemp(f"ref_{kind}_{device_prep}")
            runs[key] = run_reference(kind, files, str(d / "dump.jsonl"),
                                      device_prep, num_devices)
        return runs[key]
    return get


def port_trainer_of(kind, ref, device_prep=None, dump_path=None,
                    trainer_conf=None):
    """The port's trainer from the reference run's initial weights and
    arena, over a native one-thread table on the CPU."""
    _, from_leaves, _ = MODELS[kind]
    table = DeviceTable(TableConfig(**TABLE), capacity=1, device="cpu",
                        backend="native", index_threads=1)
    table.load_arena(*ref["arena"])
    return CTRTrainer(from_leaves(ref["init"], HIDDEN), port_feed_conf(),
                      TableConfig(**TABLE), trainer_conf or TrainerConfig(),
                      table=table, dump_path=dump_path,
                      device_prep=device_prep)


def train_pass(tr, ds):
    fetched = []
    metrics = tr.train_from_dataset(
        ds, fetch_handler=lambda s, l, p: fetched.append((s, l, p.copy())))
    return metrics, fetched


def assert_pass_matches(kind, tr, got, want):
    metrics, fetched = got
    assert [s for s, _, _ in fetched] == [s for s, _, _ in want["fetched"]]
    for (_, loss, preds), (_, jloss, jpreds) in zip(fetched,
                                                    want["fetched"]):
        np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-5)
        np.testing.assert_allclose(preds, jpreds, rtol=0, atol=1e-5)
    assert_metrics_close(metrics, want["metrics"])
    for g, w in zip(MODELS[kind][2](tr.params), want["params"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    jt = want["table"]
    t = tr.table
    assert len(t) + 1 == jt["size"]
    np.testing.assert_array_equal(t.row_keys()[1:], jt["keys"][1:])
    vals, st = t.values[:jt["size"]].numpy(), t.state[:jt["size"]].numpy()
    np.testing.assert_array_equal(vals[:, :2], jt["values"][:, :2])
    np.testing.assert_allclose(vals, jt["values"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(st, jt["state"], rtol=0, atol=1e-5)
    assert tr.timer.count["main"] == want["main"]
    assert tr.timer.count["step"] == want["step"]


def assert_metrics_close(got, want):
    assert set(got) == set(want)
    assert got["ins_num"] == want["ins_num"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_train_from_dataset_matches_reference(kind, files, reference):
    """Device prep through the trainer: per-batch losses and preds through
    ``fetch_handler``, the pass metrics, dense params, every row, the
    table's size and keys and the span counts."""
    ref = reference(kind)
    for w in CUDA_WRAPPERS:
        w.launches = 0
    tr = port_trainer_of(kind, ref)
    assert tr.step.device_prep
    got = train_pass(tr, port_dataset(files))
    assert_pass_matches(kind, tr, got, ref["pass1"])
    assert got[0]["ins_num"] == 96.0 and tr.timer.count["main"] == STEPS
    assert len(tr.table) > 0
    assert all(w.launches == 0 for w in CUDA_WRAPPERS)


def test_host_prep_branch_matches_reference(files, reference):
    """``device_prep=False``: the trainer drives ``FusedTrainStep.__call__``
    (host ``prepare_batch``), as the reference's does."""
    ref = reference("deepfm", device_prep=False)
    tr = port_trainer_of("deepfm", ref, device_prep=False)
    assert not tr.step.device_prep
    assert_pass_matches("deepfm", tr, train_pass(tr, port_dataset(files)),
                        ref["pass1"])


def test_auc_drain_every_n_steps(files, reference, monkeypatch):
    """A second pass with ``AUC_DRAIN_STEPS`` = 4 in both packages: the
    same metrics, and the port drains at steps 16, 20 and 24 and at the
    pass end."""
    ref = reference("deepfm")
    tr = port_trainer_of("deepfm", ref)
    ds = port_dataset(files)
    train_pass(tr, ds)
    tr.reset_metrics()
    assert tr.timer.count["main"] == 0
    drained = []
    drain = tr._drain_auc
    monkeypatch.setattr(tr, "_drain_auc",
                        lambda: (drained.append(tr._step_count), drain()))
    monkeypatch.setattr(port_trainer, "AUC_DRAIN_STEPS", 4)
    assert_pass_matches("deepfm", tr, train_pass(tr, ds), ref["pass2"])
    assert drained == [16, 20, 24, 24]


def test_evaluate_and_dump_match_reference(files, reference, tmp_path):
    ref = reference("deepfm")
    dump = str(tmp_path / "dump" / "part-0.jsonl")
    tr = port_trainer_of("deepfm", ref, dump_path=dump)
    ds = port_dataset(files)
    train_pass(tr, ds)
    tr.close_dump()
    lines = [json.loads(x) for x in open(dump)]
    assert len(lines) == len(ref["dump"]) == 96
    for got, want in zip(lines, ref["dump"]):
        assert set(got) == {"search_id", "label", "pred"}
        assert got["search_id"] == want["search_id"]
        assert got["label"] == want["label"]
        np.testing.assert_allclose(got["pred"], want["pred"], rtol=0,
                                   atol=1e-5)
    size = len(tr.table)
    assert_metrics_close(tr.evaluate(ds), ref["eval"])
    assert len(tr.table) == size   # evaluation creates no rows


def test_span_timer_matches_reference(monkeypatch):
    """``report``, ``snapshot`` and ``mean_ms`` format the same spans as
    the reference's; each span opens a ``trainer.<name>`` profiler
    range."""
    got, want = SpanTimer(metric_prefix="trainer"), JaxSpanTimer()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with got.span("step"):
            pass
    assert any(e.name == "trainer.step" for e in prof.events())
    got.reset()
    for t in (got, want):
        for name, secs in (("main", 0.0125), ("step", 0.01),
                           ("main", 0.0375)):
            t.total[name] += secs
            t.count[name] += 1
        t.total["idle"] += 0.0
    assert got.report() == want.report()
    assert got.snapshot() == want.snapshot()
    assert got.mean_ms("main") == want.mean_ms("main") == 25.0
    assert got.mean_ms("none") == 0.0


def test_profile_line(files, reference, capfd):
    tr = port_trainer_of("deepfm", reference("deepfm"),
                         trainer_conf=TrainerConfig(profile=True))
    tr.train_from_dataset(port_dataset(files))
    err = capfd.readouterr().err.strip().splitlines()
    # the line, then (fused engine, as the reference's) the first batch's
    # section table (test_torch_profiler.py)
    line, sections = err[-1].split("  sections[")
    assert line == (f"log_for_profile pass_steps={STEPS} "
                    f"{tr.timer.report()}")
    assert "main: " in line and "step: " in line
    assert sections.endswith("]") and "step_total=" in sections


# the four TrainerConfig fields of the trainer loop (FusedTrainStep reads
# none of them): on one device the trainer ignores dense_sync_steps,
# metrics and num_devices, as the reference does (num_devices > 1 without a
# mesh trains on one device in both packages: held against the reference
# run at the same value), and prints the profile line
@pytest.mark.parametrize("field,value", [
    ("dense_sync_steps", 4), ("metrics", ["auc", "mae"]),
    ("num_devices", 4), ("num_devices", 2), ("profile", True)])
def test_trainer_config_fields(files, reference, capfd, field, value):
    ref = reference("deepfm", num_devices=value if field == "num_devices"
                    else 1)
    conf = TrainerConfig(**{field: value})
    tr = port_trainer_of("deepfm", ref, trainer_conf=conf)
    if field == "num_devices":
        assert tr.mesh is None and tr.ndev == 1
    assert_pass_matches("deepfm", tr, train_pass(tr, port_dataset(files)),
                        ref["pass1"])
    assert ("log_for_profile" in capfd.readouterr().err) == \
        (field == "profile")


def _table():
    return DeviceTable(TableConfig(**TABLE), capacity=64, device="cpu",
                       backend="native", index_threads=1)


def _trainer(**kw):
    kw.setdefault("table", _table())
    return CTRTrainer(torch.nn.Linear(1, 1), port_feed_conf(),
                      TableConfig(**TABLE), TrainerConfig(), **kw)


REFUSED = {}
# options once refused here, which now build (test_torch_deferred_insert.py
# holds "deferred" to the reference; test_torch_mp_reader.py and
# test_torch_stream.py train_from_files(workers=2); a mesh over a device
# table test_torch_fused_sharded.py, over a host table
# test_torch_trainer_mesh.py; the dense sync hook test_torch_multihost.py)
PORTED = {"dense_sync_hook": lambda: _trainer(dense_sync_hook=lambda p: p),
          "deferred": lambda: _trainer(insert_mode="deferred"),
          "train_from_files": lambda: _trainer(),
          "mesh": lambda: _trainer(mesh=make_mesh(2, device="cpu"),
                                   table=None, use_device_table=False)}
REFUSED_FLAGS = {}


def _feed_flag(tmp_path):
    """The staged feed's flag builds the trainer (depth 2, 5 buffers) and
    refuses the host-table engine, as the reference does."""
    assert feed_prefetch_conf() == (2, 5)
    assert _trainer().step.device_prep
    with pytest.raises(ValueError, match="fused engine"):
        _trainer(table=EmbeddingTable(TableConfig(**TABLE)), device="cpu")


def _trace_flag(tmp_path):
    was = port_trace.TRACE.enabled
    try:
        _trainer()
        assert port_trace.enabled()
    finally:
        if not was:
            port_trace.disable()


def _heartbeat_flag(tmp_path):
    _trainer()
    assert port_heartbeat.sink_path() == str(tmp_path / "hb.jsonl")


def _nan_inf_flag(tmp_path):
    """The flag attaches an abort-policy guard to a fused trainer."""
    tr = _trainer()
    try:
        assert tr._guard is not None and \
            tr._guard.policy.action_for("nan") == "abort"
    finally:
        tr._guard.detach()


def _postmortem_flag(tmp_path):
    """The flag installs the crash hooks at construction."""
    _trainer()
    assert port_postmortem._installed


# the reference's flags once refused here, now ported (A.4 and A.6;
# test_torch_device_feed.py, test_torch_obs.py, test_torch_guard.py and
# test_torch_postmortem.py hold them to the reference)
PORTED_FLAGS = {"feed_device_prefetch": ("2", _feed_flag),
                "obs_trace_dir": ("{tmp}/trace", _trace_flag),
                "obs_heartbeat_path": ("{tmp}/hb.jsonl", _heartbeat_flag),
                "check_nan_inf": ("true", _nan_inf_flag),
                "obs_postmortem_dir": ("{tmp}/pm", _postmortem_flag)}


@pytest.mark.parametrize("what", sorted(REFUSED) + sorted(PORTED)
                         + sorted(REFUSED_FLAGS) + sorted(PORTED_FLAGS))
def test_unported_options_refused(what, monkeypatch, tmp_path):
    if what in PORTED_FLAGS:
        value, check = PORTED_FLAGS[what]
        monkeypatch.setenv(f"PBOX_FLAGS_{what}",
                           value.format(tmp=tmp_path))
        check(tmp_path)
        return
    if what == "train_from_files":
        # workers > 1 builds the multi-process reader: a file it cannot
        # read fails in its worker, named, and no step is taken
        tr = PORTED[what]()
        with pytest.raises(RuntimeError,
                           match="parse worker failed on shard 0"):
            tr.train_from_files(["x"], workers=2)
        assert tr._step_count == 0
        return
    if what == "mesh":
        tr = PORTED[what]()
        assert isinstance(tr.step, ShardedTrainStep) and not tr.fused
        return
    if what == "dense_sync_hook":
        # kept, and called by the mesh paths only
        tr = PORTED[what]()
        assert tr.dense_sync_hook is not None and tr.mesh is None
        return
    if what in PORTED:
        tr = PORTED[what]()
        assert tr.step.device_prep and tr.step.insert_mode == "deferred"
        assert tr.table.miss_ring is not None
        return
    if what in REFUSED:
        fn, item = REFUSED[what]
    else:
        value, item = REFUSED_FLAGS[what]
        # off values of the flag do not refuse
        for off in ("", "0", "false"):
            monkeypatch.setenv(f"PBOX_FLAGS_{what}", off)
            _trainer()
        monkeypatch.setenv(f"PBOX_FLAGS_{what}", value)
        fn = _trainer
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        fn()


def test_insert_mode_validated_and_gated():
    """A typo'd insert_mode raises; "deferred" with device prep off warns
    and trains in "ensure" mode, as the reference's does."""
    with pytest.raises(ValueError, match="insert_mode"):
        _trainer(insert_mode="defered")
    with pytest.warns(RuntimeWarning, match="deferred"):
        tr = _trainer(device_prep=False, insert_mode="deferred")
    assert tr.step.insert_mode == "ensure" and not tr.step.device_prep


def test_device_prep_resolves_like_reference():
    """Auto device prep: on over a one-thread native index, off over the
    multi-thread ``MtIndex`` or the numpy index."""
    assert _trainer().step.device_prep
    for backend, threads in (("native", 2), ("numpy", 0)):
        t = DeviceTable(TableConfig(**TABLE), capacity=64, device="cpu",
                        backend=backend, index_threads=threads)
        assert not _trainer(table=t).step.device_prep


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _trainer(table=None)
    tr = _trainer(table=None, device="cpu", device_capacity=64)
    assert tr.table.device == torch.device("cpu")
    assert tr.table.capacity == 64


# -- the host-table engine ----------------------------------------------------

def host_rows(table):
    snap = table.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return [snap[k][order] for k in ("keys", "values", "state",
                                     "embedx_ok")]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_host_engine_matches_reference(kind, files):
    """``use_device_table=False``: pull -> ``TrainStep`` -> push over each
    package's ``EmbeddingTable(backend="numpy")`` (the same key-
    deterministic init), ``train_from_dataset`` then ``evaluate``, from the
    reference trainer's params: per-batch losses and preds, the pass and
    evaluation metrics, every row by key (show/clk exact) and the dense
    params; the spans pull, step and push once a batch; evaluation creates
    no rows and launches no kernel."""
    host_engine_matches_reference(kind, files, TrainerConfig())


def test_host_engine_under_bf16_matches_reference(files):
    """``CTRTrainer(use_device_table=False)`` with ``bf16=True`` in both
    packages: the host engine ignores the flag in both, so the same
    checks hold within 1e-5 with no rounding added on either side."""
    host_engine_matches_reference("deepfm", files, TrainerConfig(bf16=True))


@pytest.mark.parametrize("options", [
    dict(dense_optimizer="lamb", dense_learning_rate=0.01,
         dense_weight_decay=1e-3, grad_merge_steps=2, recompute=True),
    dict(dense_optimizer="lars", dense_learning_rate=0.5,
         dense_weight_decay=1e-3, grad_merge_steps=3)])
def test_host_engine_dense_options_match_reference(options, files):
    """``CTRTrainer(use_device_table=False)`` with lamb or lars under
    gradient merging (and recompute) in both packages: the same checks
    as ``test_host_engine_matches_reference``, within 1e-5."""
    host_engine_matches_reference("deepfm", files, TrainerConfig(**options))


def host_engine_matches_reference(kind, files, tconf):
    flax_cls, from_leaves, to_leaves = MODELS[kind]
    jtr = ref_trainer.CTRTrainer(
        flax_cls(hidden=HIDDEN), jax_feed_conf(), JaxTableConfig(**TABLE),
        JaxTrainerConfig(**dataclasses.asdict(tconf)),
        table=JaxTable(JaxTableConfig(**TABLE), backend="numpy"))
    assert not jtr.fused
    tr = CTRTrainer(from_leaves(leaves_of(jtr.params), HIDDEN),
                    port_feed_conf(), TableConfig(**TABLE), tconf,
                    use_device_table=False, device="cpu")
    assert not tr.fused and isinstance(tr.table, EmbeddingTable)
    tr.table = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    ds = JaxSlotDataset(jax_feed_conf())
    ds.set_filelist(files)
    ds.load_into_memory()
    want_fetched = []
    want = jtr.train_from_dataset(ds, fetch_handler=lambda s, l, p:
                                  want_fetched.append((s, l, np.asarray(p))))
    for w in CUDA_WRAPPERS:
        w.launches = 0
    pds = port_dataset(files)
    metrics, fetched = train_pass(tr, pds)
    assert [s for s, _, _ in fetched] == [s for s, _, _ in want_fetched]
    for (_, loss, preds), (_, jloss, jpreds) in zip(fetched, want_fetched):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(preds, jpreds, rtol=1e-5, atol=1e-6)
    assert_metrics_close(metrics, want)
    assert metrics["ins_num"] == 96.0
    got, ref = host_rows(tr.table), host_rows(jtr.table)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1][:, :2], ref[1][:, :2])
    np.testing.assert_array_equal(got[3], ref[3])
    for g, w in zip(got[1:3], ref[1:3]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for g, w in zip(to_leaves(tr.params), leaves_of(jtr.params)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for span in ("main", "pull", "step", "push"):
        assert tr.timer.count[span] == jtr.timer.count[span] == STEPS
    size = len(tr.table)
    assert_metrics_close(tr.evaluate(pds), jtr.evaluate(ds))
    assert len(tr.table) == size
    assert all(w.launches == 0 for w in CUDA_WRAPPERS)


def test_host_table_selects_the_host_engine():
    """A host ``EmbeddingTable`` as ``table`` selects the host-table engine
    whatever ``use_device_table`` says, as in the reference; the trainer
    carries the named metric registry."""
    t = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    tr = _trainer(table=t, device="cpu")
    assert tr.table is t and not tr.fused
    assert type(tr.step).__name__ == "TrainStep"
    assert tr.metrics.names() == []
    tr.metrics.init_metric("ctr_auc")
    assert tr.metrics.names() == ["ctr_auc"]


def test_table_of_another_type_raises():
    with pytest.raises(TypeError, match="DeviceTable"):
        _trainer(table=object())


def test_train_from_files_on_host_engine_raises(files):
    tr = _trainer(use_device_table=False, table=None, device="cpu")
    with pytest.raises(ValueError, match="train_from_dataset"):
        tr.train_from_files(files)
