"""Port's dense lars, lamb, gradient merging (``optax.MultiSteps``) and
recompute (``trainer/train_step.py``) against the JAX package's, on the
CPU: the optimizers alone against optax (every state leaf in the
``dense.npz`` order too), then the host-table ``TrainStep`` and the
``FusedTrainStep`` against the reference's steps over 2k+1 steps, from
the same flax params and the same tables. Port only: recompute is bit for
bit the plain step; under gradient merging the dense params do not move
on the k-1 steps between emits; ``update`` reads nothing back to the host;
and a run graph (the stand-in graph of ``test_torch_step_graph.py``)
replays lars under gradient merging bit for bit against the eager run.

Tolerances: the optimizers alone rtol 1e-6, atol 1e-7 (as
``test_torch_fused_step.py::test_dense_optimizer_matches_optax``); the
steps' loss, preds, demb and dense params rtol 1e-5, atol 1e-6 (float32
GEMMs in another order), demb's show/clk and the rows' show/clk exact;
the fused step's rows by key atol 1e-6."""

import jax
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer.fused_step import FusedTrainStep as JaxStep
from paddlebox_tpu.trainer.train_step import TrainStep as JaxTrainStep
from paddlebox_tpu.trainer.train_step import \
    make_dense_optimizer as jax_dense_optimizer
from paddlebox_tpu.utils.checkpoint import pytree_arrays
from paddlebox_tpu_torch.config import BucketSpec, TableConfig, TrainerConfig
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_deepfm)
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer import step_graph
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.train_step import (TrainStep,
                                                    make_dense_optimizer)
from paddlebox_tpu_torch.utils.checkpoint import dense_arrays
from test_torch_step_graph import ReplayingRunGraph, _no_host_reads
from test_torch_stream import make_stream

B, S, DD, NPAD = 16, 4, 3, 160
EDIM = 4
HIDDEN = (16, 8)
RTOL, ATOL = 1e-5, 1e-6
STEPS = 7                       # 2k + 1 for the largest k, 3
CONFIGS = {
    "lars": dict(dense_optimizer="lars", dense_learning_rate=0.5,
                 dense_weight_decay=1e-3),
    "lamb": dict(dense_optimizer="lamb", dense_learning_rate=0.01,
                 dense_weight_decay=1e-3),
    "merge2_adam": dict(dense_optimizer="adam", dense_learning_rate=1e-3,
                        grad_merge_steps=2),
    "merge3_lamb": dict(dense_optimizer="lamb", dense_learning_rate=0.01,
                        dense_weight_decay=1e-3, grad_merge_steps=3),
    "recompute": dict(dense_optimizer="adam", dense_learning_rate=1e-3,
                      recompute=True),
}
TABLE = dict(embedx_dim=EDIM, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.05, embedx_threshold=0.0, initial_range=0.05,
             seed=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """JAX's CPU thread pools spin beside torch's intra-op threads and slow
    these small torch ops several times over; one thread is enough."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves_of(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def make_batches(seed, n=STEPS, vocab=60):
    """``n`` batches of B rows of S slots with 1-3 keys each (padding key
    0, segment B*S), DD dense values, the last two rows masked."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(1, 4, size=B * S)
        k = int(lengths.sum())
        keys = np.zeros(NPAD, np.uint64)
        keys[:k] = rng.integers(1, vocab, size=k)
        segs = np.full(NPAD, B * S, np.int32)
        segs[:k] = np.repeat(np.arange(B * S, dtype=np.int32), lengths)
        labels = (rng.uniform(size=B) < 0.4).astype(np.float32)
        cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
        dense = rng.normal(size=(B, DD)).astype(np.float32)
        mask = np.ones(B, np.float32)
        mask[-2:] = 0.0
        out.append((keys, segs, cvm, labels, dense, mask))
    return out


# -- the optimizers alone ------------------------------------------------------

@pytest.mark.parametrize("name,k", [("lars", 1), ("lamb", 1), ("adam", 2),
                                    ("lars", 3), ("lamb", 2)])
def test_optimizer_matches_optax(name, k, monkeypatch):
    """2k+1 steps of random grads on a small DeepFM (a leaf with a zero
    grad among them), ``update`` run with every host read of a tensor
    refused: the params and every state leaf, in the ``dense.npz`` order,
    against optax's."""
    rng = np.random.default_rng(21)
    kw = dict(dense_optimizer=name, dense_learning_rate=0.05,
              dense_weight_decay=0.01, grad_merge_steps=k)
    jparams = FlaxDeepFM(hidden=(6,)).init(
        jax.random.PRNGKey(4), np.zeros((2, 3, 7), np.float32),
        np.zeros((2, 2), np.float32))
    model = deepfm_from_flax_leaves(leaves_of(jparams), (6,))
    opt, jopt = (make_dense_optimizer(TrainerConfig(**kw)),
                 jax_dense_optimizer(JaxTrainerConfig(**kw)))
    state, jstate = opt.init(model), jopt.init(jparams)
    for step in range(2 * k + 1):
        grads = [rng.normal(size=np.shape(x)).astype(np.float32)
                 for x in jax.tree_util.tree_leaves(jparams)]
        grads[0][:] = 0.0
        jgrads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams), grads)
        port = deepfm_from_flax_leaves(grads, (6,))
        for p, g in zip(model.parameters(), port.parameters()):
            p.grad = g.detach().clone()
        before = [p.detach().clone() for p in model.parameters()]
        with monkeypatch.context() as m:
            _no_host_reads(m)
            state = opt.update(model, state)
        updates, jstate = jopt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        moved = any(not torch.equal(a, p) for a, p in
                    zip(before, model.parameters()))
        assert moved == ((step + 1) % k == 0)
    got = dense_arrays((model, state))
    want = pytree_arrays((jparams, jstate))
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    if k > 1:
        assert int(state["gradient_step"]) == 2
        assert int(state["mini_step"]) == 1


# -- the host-table step -------------------------------------------------------

def host_worlds(conf):
    jconf, pconf = JaxTableConfig(**TABLE), TableConfig(**TABLE)
    jstep = JaxTrainStep(FlaxDeepFM(hidden=HIDDEN), jconf,
                         JaxTrainerConfig(**conf), B, S, DD)
    jparams, jopt = jstep.init(jax.random.PRNGKey(0))
    model = deepfm_from_flax_leaves(leaves_of(jparams), HIDDEN)
    step = TrainStep(model, pconf, TrainerConfig(**conf), B, S, DD,
                     device="cpu")
    return ((jstep, JaxTable(jconf, backend="numpy"),
             [jparams, jopt, jstep.init_auc_state()]),
            (step, EmbeddingTable(pconf, backend="numpy"),
             [*step.init(), step.init_auc_state()]))


def host_steps(step, table, st, batches):
    """Pull, step, push over ``batches``; each step's (demb, loss, preds,
    params after it)."""
    out = []
    for keys, segs, cvm, labels, dense, mask in batches:
        emb = table.pull(keys)
        *st, demb, loss, preds = step(*st, emb, segs, cvm, labels, dense,
                                      mask)
        table.push(keys, np.asarray(demb))
        out.append((np.asarray(demb), float(loss), np.asarray(preds),
                    [p.detach().clone() for p in st[0].parameters()]))
    return st, out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_step_matches_reference(name):
    """The host-table ``TrainStep`` over each package's ``EmbeddingTable``
    (key-deterministic init, so two fresh tables agree): demb, loss and
    preds of every step, then the rows by key and the dense params."""
    (jstep, jt, js), (step, pt, ps) = host_worlds(CONFIGS[name])
    batches = make_batches(1)
    ps, got = host_steps(step, pt, ps, batches)
    for (keys, segs, cvm, labels, dense, mask), g in zip(batches, got):
        jemb = jt.pull(keys)
        *js, jdemb, jloss, jpreds = jstep(*js, jemb, segs, cvm, labels,
                                          dense, mask)
        jdemb = np.asarray(jdemb)
        jt.push(keys, jdemb)
        np.testing.assert_array_equal(g[0][:, :2], jdemb[:, :2])
        close(g[0], jdemb, "demb")
        close(g[1], float(jloss), "loss")
        close(g[2], jpreds, "preds")
    a, b = pt.snapshot(reset_dirty=False), jt.snapshot(reset_dirty=False)
    oa, ob = np.argsort(a["keys"]), np.argsort(b["keys"])
    np.testing.assert_array_equal(a["keys"][oa], b["keys"][ob])
    np.testing.assert_array_equal(a["values"][oa][:, :2],
                                  b["values"][ob][:, :2])
    close(a["values"][oa], b["values"][ob], "values")
    for got, want in zip(flax_leaves_from_deepfm(ps[0]), leaves_of(js[0])):
        close(got, want, "dense params")


# -- the fused step --------------------------------------------------------------

def fused_worlds(conf):
    kw = dict(TABLE, seed=3)
    jt = JaxDeviceTable(JaxTableConfig(**kw), capacity=1024,
                        uniq_buckets=JaxBucketSpec(min_size=256),
                        backend="numpy")
    jfs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt, JaxTrainerConfig(**conf),
                  B, S, dense_dim=DD)
    jp, jo = jfs.init(jax.random.PRNGKey(0))
    pt = DeviceTable(TableConfig(**kw), capacity=1024,
                     uniq_buckets=BucketSpec(min_size=256), device="cpu",
                     backend="numpy")
    pt.load_arena(np.asarray(jt.values), np.asarray(jt.state),
                  jt._index.dump_keys(jt._size))
    pfs = FusedTrainStep(deepfm_from_flax_leaves(leaves_of(jp), HIDDEN), pt,
                         TrainerConfig(**conf), B, S, dense_dim=DD)
    return (jfs, jt, [jp, jo, jfs.init_auc_state()]), \
        (pfs, pt, [*pfs.init(), pfs.init_auc_state()])


def by_key(snap):
    order = np.argsort(snap["keys"])
    return snap["keys"][order], snap["values"][order], snap["state"][order]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_step_matches_reference(name):
    """``FusedTrainStep`` (host prep) over each package's ``DeviceTable``
    holding the same arena: loss and preds of every step, then the dense
    params and the rows by key."""
    (jfs, jt, js), (pfs, pt, ps) = fused_worlds(CONFIGS[name])
    for batch in make_batches(2):
        *js, jloss, jpreds = jfs(*js, *batch)
        *ps, loss, preds = pfs(*ps, *batch)
        close(float(loss), float(jloss), "loss")
        close(preds.numpy(), jpreds, "preds")
    for got, want in zip(flax_leaves_from_deepfm(ps[0]), leaves_of(js[0])):
        close(got, want, "dense params")
    jk, jv, jst = by_key(jt.snapshot())
    pk, pv, pst = by_key(pt.snapshot())
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pst, jst, rtol=0, atol=1e-6)


# -- port only -------------------------------------------------------------------

def test_recompute_is_bit_identical_to_plain():
    """The host-table step and the fused step with ``recompute`` against
    the same steps without it, from the same weights and tables: demb,
    losses, preds and the dense params bit for bit."""
    plain = dict(CONFIGS["recompute"], recompute=False)
    runs = {}
    for rc in (True, False):
        conf = CONFIGS["recompute"] if rc else plain
        _, (step, pt, ps) = host_worlds(conf)
        ps, host = host_steps(step, pt, ps, make_batches(3, 3))
        _, (pfs, ft, fs) = fused_worlds(conf)
        fused = []
        for batch in make_batches(4, 3):
            *fs, loss, preds = pfs(*fs, *batch)
            fused.append((loss, preds))
        runs[rc] = (host, fused, list(fs[0].parameters()))
    for a, b in zip(runs[True][0], runs[False][0]):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])
        for x, y in zip(a[3], b[3]):
            assert torch.equal(x, y)
    for (la, pa), (lb, pb) in zip(runs[True][1], runs[False][1]):
        assert torch.equal(la, lb) and torch.equal(pa, pb)
    for x, y in zip(runs[True][2], runs[False][2]):
        assert torch.equal(x, y)


GRAPH_TABLE = dict(embedx_dim=EDIM, cvm_offset=3, embedx_threshold=0.0,
                   initial_range=0.05, learning_rate=0.05, seed=11)


def graph_world(conf, graphs):
    torch.manual_seed(3)
    model = DeepFM(3 * (3 + EDIM) + 2, (16,))
    t = DeviceTable(TableConfig(**GRAPH_TABLE), capacity=500, device="cpu",
                    backend="native", index_threads=1)
    t.prepopulate(300)
    fs = FusedTrainStep(model, t, TrainerConfig(**conf), 8, 3, dense_dim=2,
                        num_auc_buckets=1 << 10, device_prep=True)
    if graphs:
        fs.run_graphs = step_graph.RunGraphs(fs)
    return fs, t, [*fs.init(), fs.init_auc_state()]


@pytest.mark.skipif(not ref_native.available(),
                    reason="native backend unavailable")
@pytest.mark.parametrize("name", ["merge3_lars", "recompute"])
def test_run_graph_replays_equal_eager_runs(name, monkeypatch):
    """Four runs of 16 device-prep steps through ``train_stream``: with
    run graphs (the stand-in graph that replays the captured body) and
    eagerly, on twin tables. Lars under gradient merging (its
    ``mini_step`` and ``gradient_step`` device tensors in place) and
    recompute: every loss, the dense params and every optimizer state
    tensor bit for bit, three replays of one capture."""
    conf = (dict(dense_optimizer="lars", dense_learning_rate=0.5,
                 dense_weight_decay=1e-3, grad_merge_steps=3)
            if name == "merge3_lars" else CONFIGS["recompute"])
    monkeypatch.setattr(step_graph, "RunGraph", ReplayingRunGraph)
    stream = [b for seed in (1, 2, 4, 5)
              for b in make_stream(seed=seed, vocab=301)[:16]]
    gfs, gt, gs = graph_world(conf, True)
    efs, et, es = graph_world(conf, False)
    glosses, elosses = [], []
    *gs, _, _ = gfs.train_stream(*gs, iter(stream),
                                 on_step=lambda s, l: glosses.append(l))
    *es, _, _ = efs.train_stream(*es, iter(stream),
                                 on_step=lambda s, l: elosses.append(l))
    assert (gfs.run_graphs.captures, gfs.run_graphs.replays) == (1, 3)
    assert torch.equal(torch.stack(glosses), torch.stack(elosses))
    for a, b in zip(gs[0].parameters(), es[0].parameters()):
        assert torch.equal(a, b)
    ga = list(step_graph.state_tensors(gs[1]))
    ea = list(step_graph.state_tensors(es[1]))
    assert len(ga) == len(ea) > 0
    for a, b in zip(ga, ea):
        assert torch.equal(a, b)
    if name == "merge3_lars":
        assert int(gs[1]["gradient_step"]) == 64 // 3
        assert int(gs[1]["mini_step"]) == 64 % 3
