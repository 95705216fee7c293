"""Port's run graph (``trainer/step_graph.py``) and what it needs of the
step, on the CPU: adam's step count on the device against optax, the AUC
state zeroed in place at a drain (pass metrics against the reference
trainer's), the run key against every event that puts new tensors in a
capture's way, the launch-count bookkeeping of a capture and its replays,
and ``train_stream``'s graph path, driven through a stand-in graph that
runs the captured body at each replay, against the eager run path.

Tolerances: dense params after 5 optax steps rtol 1e-6, atol 1e-7 (as
``test_torch_fused_step.py::test_dense_optimizer_matches_optax``), adam's
``mu`` and ``nu`` the same, ``count`` exact; pass metrics ``ins_num``
exact, the rest rtol 1e-5 (as ``test_torch_stream.py``). Port against
port (graph path against eager path) is exact."""

import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.trainer.train_step import \
    make_dense_optimizer as jax_dense_optimizer
from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.ops import (device_index_kernel, seqpool_kernel,
                                     sparse_push)
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.trainer import step_graph
from paddlebox_tpu_torch.trainer import trainer as port_trainer
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.train_step import make_dense_optimizer
from test_torch_stream import (AUC_BUCKETS, B, DD, HIDDEN, NPAD_A, NPAD_B,
                               PREPOP, TABLE, TRAIN, assert_same_rows_by_key,
                               make_stream, port_files_trainer,
                               reference_files_run, write_file)

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native backend unavailable")

S = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """JAX's CPU thread pools spin beside torch's intra-op threads and slow
    these small torch ops several times over; one thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_host_reads(monkeypatch):
    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor was read back to the host")
    for name in ("item", "tolist", "__float__", "__int__", "__bool__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_count_on_device_matches_optax(name, monkeypatch):
    """Five steps of random grads on a small module, ``update`` run with
    every host read of a tensor refused: the params, ``mu``, ``nu`` and
    the int32 ``count`` against optax's."""
    rng = np.random.default_rng(13)
    kw = dict(dense_optimizer=name, dense_learning_rate=0.01,
              dense_weight_decay=0.1)
    model = torch.nn.Linear(5, 3)
    params = [p.detach().numpy().copy() for p in model.parameters()]
    opt, jopt = (make_dense_optimizer(TrainerConfig(**kw)),
                 jax_dense_optimizer(JaxTrainerConfig(**kw)))
    state, jstate = opt.init(model), jopt.init(params)
    count = state["count"]
    assert count.dtype == torch.int32 and count.dim() == 0
    for _ in range(5):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        for p, g in zip(model.parameters(), grads):
            p.grad = torch.from_numpy(g.copy())
        with monkeypatch.context() as m:
            _no_host_reads(m)
            state = opt.update(model, state)
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
    adam = jstate[0]
    assert state["count"] is count
    assert int(count) == int(adam.count) == 5
    for got, want in zip(model.parameters(), params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    for f in ("mu", "nu"):
        for got, want in zip(state[f], getattr(adam, f)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7, err_msg=f)


def test_drain_auc_zeroes_in_place_and_pass_matches_reference(
        tmp_path, monkeypatch):
    """A ``train_from_files`` pass with ``AUC_DRAIN_STEPS`` = 4 in both
    packages: each drain leaves the same AUC tensors, zeroed, and the pass
    metrics equal the reference trainer's."""
    files = [write_file(str(tmp_path / f"part-{i}"), 60, 1, 2, 20 + i)
             for i in range(2)]
    ref = reference_files_run(files, 4)
    tr = port_files_trainer(ref)
    state = tr.auc_state
    tensors = dict(state)
    drained = []
    drain_auc = tr._drain_auc

    def drain():
        drain_auc()
        assert tr.auc_state is state
        assert all(state[k] is t for k, t in tensors.items())
        assert all(not t.any() for t in state.values())
        drained.append(tr._step_count)

    monkeypatch.setattr(tr, "_drain_auc", drain)
    monkeypatch.setattr(port_trainer, "AUC_DRAIN_STEPS", 4)
    metrics = tr.train_from_files(files)
    assert drained == [4, 8, 12, 15]
    assert metrics["ins_num"] == ref["metrics"]["ins_num"] == 120
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(metrics[k], want, rtol=1e-5, err_msg=k)


def world(capacity=500, graphs=False):
    """A device-prep step over a native one-thread table of PREPOP rows
    (the setup of ``test_torch_stream.py::
    test_stream_run_sees_arena_growth_and_index_rehash``); with ``graphs``
    its full runs go through ``RunGraphs`` as on the card."""
    torch.manual_seed(3)
    model = DeepFM(S * (TABLE["cvm_offset"] + TABLE["embedx_dim"]) + DD,
                   HIDDEN)
    t = DeviceTable(TableConfig(**TABLE), capacity=capacity, device="cpu",
                    backend="native", index_threads=1)
    t.prepopulate(PREPOP)
    fs = FusedTrainStep(model, t, TrainerConfig(**TRAIN), B, S,
                        dense_dim=DD, num_auc_buckets=AUC_BUCKETS,
                        device_prep=True)
    assert fs.run_graphs is None   # the CPU runs every run eagerly
    if graphs:
        fs.run_graphs = step_graph.RunGraphs(fs)
    return fs, t, [*fs.init(), fs.init_auc_state()]


def run_shape(fs, npad):
    """The ``shape`` part of a run key: the layout of a packed run of
    ``DEV_CHUNK`` batches of ``npad`` keys, and one label a row."""
    k = fs.DEV_CHUNK
    _, layout = fs._pack([[np.zeros(npad, np.int64)] * k,
                          [np.zeros(npad, np.int32)] * k,
                          [np.zeros(B * (2 + 1 + DD + 1), np.float32)] * k])
    return layout, 1


def new_keys(start, n):
    return np.arange(start, start + n, dtype=np.uint64)


def test_run_key_changes_exactly_with_what_a_capture_bakes_in():
    """The key of a run moves on an arena growth, a mirror resync at a new
    capacity, ``load_arena``, a new optimizer or AUC state and a run-shape
    change; it stays through steps, inserts that neither grow nor rehash,
    a resync in place, an AUC drain and ``end_pass``."""
    fs, t, st = world()
    shape = run_shape(fs, NPAD_A)

    def key(shape=shape):
        return step_graph.run_key(fs, *st, shape)

    k0 = key()
    assert key(run_shape(fs, NPAD_B)) != k0
    # steps, an insert within capacity, a resync in place, a drain
    stream = make_stream(seed=7, vocab=PREPOP + 1)[:20]
    *st, _, _ = fs.train_stream(*st, iter(stream))
    t.ensure_keys(new_keys(1 << 20, 50))
    t.mirror.sync()
    port_trainer.reset_auc_state_(st[2])
    t.end_pass()
    assert key() == k0 and t.capacity == 500
    # the arena grows (351 + 150 rows > 500), the map does not rehash
    gen = t.mirror.generation
    t.ensure_keys(new_keys(2 << 20, 150))
    assert t.capacity == 1000 and t.mirror.generation == gen
    k1 = key()
    assert k1 != k0 and k1[1][2] == k0[1][2]
    # the map rehashes (716 of its 1024 slots) and the mirror moves to a
    # table of 2048, the arena does not grow
    t.ensure_keys(new_keys(3 << 20, 250))
    assert t.capacity == 1000 and t.mirror.generation > gen
    k2 = key()
    assert k2 != k1 and k2[1][:2] == k1[1][:2] and k2[2] != k1[2]
    # load_arena takes over new tensors at the same shapes
    snap = (t.values.numpy().copy(), t.state.numpy().copy(), t.row_keys())
    t.load_arena(*snap)
    assert key() != k2
    k3 = key()
    # new optimizer and AUC states
    assert step_graph.run_key(fs, st[0], fs.init()[1], st[2], shape) != k3
    assert step_graph.run_key(fs, st[0], st[1], fs.init_auc_state(),
                              shape) != k3
    assert key() == k3


def test_launch_delta_takes_back_the_capture_and_counts_replays():
    def stub_a():
        stub_a.launches += 1

    def stub_b():
        stub_b.launches += 1

    stub_a.launches, stub_b.launches = 5, 7
    delta = step_graph.LaunchDelta((stub_a, stub_b))
    with delta.capture():
        stub_a()
        stub_a()
        stub_b()
    assert (stub_a.launches, stub_b.launches) == (5, 7)
    assert delta.by_name() == {"stub_a": 2, "stub_b": 1}
    for _ in range(3):
        delta.replayed()
    assert (stub_a.launches, stub_b.launches) == (11, 10)
    # a capture that fails launched nothing either
    with pytest.raises(RuntimeError):
        with step_graph.LaunchDelta((stub_a,)).capture():
            stub_a()
            raise RuntimeError("capture failed")
    assert stub_a.launches == 11


def test_counted_wrappers_are_every_counting_wrapper():
    found = {f for mod in (device_index_kernel, seqpool_kernel, sparse_push)
             for f in vars(mod).values()
             if callable(f) and hasattr(f, "launches")}
    assert found == set(step_graph.COUNTED_WRAPPERS)


class ReplayingRunGraph(step_graph.RunGraph):
    """Stands in for the CUDA graph on the CPU: capture keeps the body and
    executes nothing, each replay runs it over the static buffer."""

    def _capture(self, body):
        self.body = body
        return None

    def _launch(self):
        self.out = self.body()


def graph_stream():
    """Four runs of 16 at Npad A: within the prepopulated rows, again,
    then with new keys that grow the arena (500 rows) and rehash the map,
    then again; 50 batches at Npad B (three runs of 16 and a short run of
    2), then a short last batch at A."""
    old = PREPOP + 1
    runs_a = [make_stream(seed=1, vocab=old)[:16],
              make_stream(seed=2, vocab=old)[:16],
              make_stream(seed=3, vocab=3000)[:16],
              make_stream(seed=4, vocab=old)[:16]]
    at_b = [b for seed in range(5, 30)
            for b in make_stream(seed=seed, vocab=old)[20:22]]
    return ([b for run in runs_a for b in run] + at_b +
            make_stream(seed=30, vocab=old)[38:39])


def test_train_stream_graph_path_equals_eager_run_path(monkeypatch):
    """``train_stream`` with run graphs (a stand-in graph that replays by
    running the captured body over its static buffer) against the eager
    run path on a twin table, exactly: the losses of every step, the last
    loss, the dense params, adam's count, mu and nu, the AUC state and
    every row by key. A shape's first full run goes eagerly; each later
    full run replays; the arena growth and the rehash capture anew."""
    monkeypatch.setattr(step_graph, "RunGraph", ReplayingRunGraph)
    stream = graph_stream()
    gfs, gt, gs = world(graphs=True)
    efs, et, es = world()
    gen = gt.mirror.generation
    gcalls, ecalls = [], []
    *gs, gloss, gsteps = gfs.train_stream(
        *gs, iter(stream), on_step=lambda s, l: gcalls.append((s, l)))
    *es, eloss, esteps = efs.train_stream(
        *es, iter(stream), on_step=lambda s, l: ecalls.append((s, l)))
    assert gsteps == esteps == len(stream) == 64 + 50 + 1
    assert gt.capacity == et.capacity == 1000
    assert gt.mirror.generation == et.mirror.generation == gen + 1
    graphs = gfs.run_graphs
    shape_a, shape_b = run_shape(gfs, NPAD_A), run_shape(gfs, NPAD_B)
    # A: eager, capture + replay, capture again (new arena and mirror) +
    # replay, replay; B: eager, capture + replay, replay, then 2 batches
    # one by one
    assert graphs.warm == {shape_a, shape_b}
    assert (graphs.captures, graphs.replays) == (3, 5)
    assert set(graphs.graphs) == {shape_a, shape_b}
    assert [s for s, _ in gcalls] == [s for s, _ in ecalls] == \
        list(range(1, len(stream) + 1))
    assert all(l.dim() == 0 for _, l in gcalls)
    assert torch.equal(torch.stack([l for _, l in gcalls]),
                       torch.stack([l for _, l in ecalls]))
    assert torch.equal(gloss, eloss)
    assert torch.equal(gfs.bad_flag, efs.bad_flag)
    for a, b in zip(gs[0].parameters(), es[0].parameters()):
        assert torch.equal(a, b)
    assert torch.equal(gs[1]["count"], es[1]["count"])
    assert int(gs[1]["count"]) == len(stream)
    for f in ("mu", "nu"):
        for a, b in zip(gs[1][f], es[1][f]):
            assert torch.equal(a, b)
    for f in es[2]:
        assert torch.equal(gs[2][f], es[2][f]), f
    assert_same_rows_by_key(gt, et)


def test_graph_runs_mark_one_bitmap_across_clears_and_growth(monkeypatch):
    """The device dirty bitmap under run graphs (the stand-in graph),
    against the eager run path on a twin: a run captured after a save's
    clear and a replay after ``_clear_dirty`` mark the same tensor, which
    the clears zero in place (the run key stays); a run whose new keys
    grow the arena re-captures over the grown bitmap, and the marks made
    before the growth survive it. The dirty rows equal the twin's by key,
    and the keys of the runs since the last clear."""
    monkeypatch.setattr(step_graph, "RunGraph", ReplayingRunGraph)
    old = PREPOP + 1
    runs = [make_stream(seed=s, vocab=old)[:16] for s in (1, 2, 4)]
    runs.append(make_stream(seed=3, vocab=3000)[:16])
    gfs, gt, gs = world(graphs=True)
    efs, et, es = world()
    graphs = gfs.run_graphs

    def train(run):
        nonlocal gs, es
        *gs, _, _ = gfs.train_stream(*gs, iter(run))
        *es, _, _ = efs.train_stream(*es, iter(run))

    def dirty(t):
        return np.sort(t.row_keys()[t.fetch_dirty_rows()])

    def keys_of(*rs):
        keys = np.concatenate([b[0] for r in rs for b in r])
        return np.unique(keys[keys > 0])

    def key():
        return step_graph.run_key(gfs, *gs, run_shape(gfs, NPAD_A))

    train(runs[0])                                 # eager warm-up
    np.testing.assert_array_equal(dirty(gt), keys_of(runs[0]))
    bitmap, k0 = gt.dirty_dev, key()
    gt.snapshot_delta()
    et.snapshot_delta()
    assert gt.dirty_dev is bitmap and not bitmap.any() and key() == k0
    train(runs[1])                                 # captured, replayed
    assert (graphs.captures, graphs.replays) == (1, 1)
    np.testing.assert_array_equal(dirty(gt), keys_of(runs[1]))
    np.testing.assert_array_equal(dirty(gt), dirty(et))
    gt._clear_dirty()
    et._clear_dirty()
    assert gt.dirty_dev is bitmap and key() == k0
    train(runs[2])                                 # the same graph again
    assert (graphs.captures, graphs.replays) == (1, 2)
    np.testing.assert_array_equal(dirty(gt), keys_of(runs[2]))
    train(runs[3])                                 # grows: re-captured
    assert gt.capacity == et.capacity == 1000
    assert (graphs.captures, graphs.replays) == (2, 3)
    assert gt.dirty_dev is not bitmap and gt.dirty_dev.shape == (1000,)
    assert key() != k0
    np.testing.assert_array_equal(dirty(gt), keys_of(runs[2], runs[3]))
    np.testing.assert_array_equal(dirty(gt), dirty(et))
