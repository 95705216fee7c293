"""Port's FusedTrainStep (on the CPU, plain versions of the kernels) vs the
JAX package's ``FusedTrainStep`` over a numpy-backend ``DeviceTable``, from
the same flax params and the same arena, on the same numpy batches; the
device-prep step (``step_device``, native index and its mirror) against the
reference's and against the port's host-prep step; plus the dense
optimizers against optax, the masked loss, and a torch port of
``tests/test_criteo_golden.py::test_widedeep_reaches_auc``.

Tolerances: per-step loss rtol 1e-5; dense params after 5 steps rtol 1e-4,
atol 1e-6; table rows by key with show/clk exact and the rest atol 1e-6
(float32 GEMMs and reductions in another order, compounded over 5
steps). Device prep, 4 steps with new keys: loss, dense params and rows
within 1e-5 (as ``tests/test_device_index.py`` holds the reference's two
modes), show/clk exact."""

import jax
import numpy as np
import optax
import pytest
import torch

from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.models import WideDeep as FlaxWideDeep
from paddlebox_tpu.ps.device_table import DeviceTable as JaxDeviceTable
from paddlebox_tpu.trainer.fused_step import FusedTrainStep as JaxStep
from paddlebox_tpu.trainer.train_step import \
    make_dense_optimizer as jax_dense_optimizer
from paddlebox_tpu_torch.config import BucketSpec, TableConfig, TrainerConfig
from paddlebox_tpu_torch.data.criteo import (N_CAT, N_DENSE, CriteoReader,
                                             make_synthetic_criteo)
from paddlebox_tpu_torch.metrics import AucCalculator
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_deepfm,
                                                flax_leaves_from_widedeep,
                                                widedeep_from_flax_leaves)
from paddlebox_tpu.ps import native as ref_native
from paddlebox_tpu_torch.ops import (device_index_kernel, seqpool_kernel,
                                     sparse_push)
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.train_step import (make_dense_optimizer,
                                                    masked_bce_loss)

B, S, EDIM, DD, NPAD = 32, 4, 4, 3, 512
HIDDEN = (16, 8)
AUC_BUCKETS = 1 << 10


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


def make_batches(seed, n, vocab=80):
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
        row_mask = np.ones(B, np.float32)
        row_mask[-3:] = 0.0
        out.append((keys, segs, cvm, labels, dense, row_mask))
    return out


def worlds(dense_opt, dense_lr, **table_kw):
    """The reference's step and the port's, from the same flax params and
    the same (carried) arena."""
    kw = dict(embedx_dim=EDIM, cvm_offset=3, initial_range=0.05, seed=3,
              **table_kw)
    jt = JaxDeviceTable(JaxTableConfig(**kw), capacity=1024,
                        uniq_buckets=JaxBucketSpec(min_size=256),
                        backend="numpy")
    jfs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt,
                  JaxTrainerConfig(dense_optimizer=dense_opt,
                                   dense_learning_rate=dense_lr),
                  B, S, dense_dim=DD, num_auc_buckets=AUC_BUCKETS)
    jp, jo = jfs.init(jax.random.PRNGKey(0))
    pt = DeviceTable(TableConfig(**kw), capacity=1024,
                     uniq_buckets=BucketSpec(min_size=256), device="cpu",
                     backend="numpy")
    pt.load_arena(np.asarray(jt.values), np.asarray(jt.state),
                  jt._index.dump_keys(jt._size))
    model = deepfm_from_flax_leaves(leaves_of(jp), HIDDEN)
    pfs = FusedTrainStep(model, pt,
                         TrainerConfig(dense_optimizer=dense_opt,
                                       dense_learning_rate=dense_lr),
                         B, S, dense_dim=DD, num_auc_buckets=AUC_BUCKETS)
    return (jfs, jt, [jp, jo, jfs.init_auc_state()]), \
        (pfs, pt, [*pfs.init(), pfs.init_auc_state()])


def by_key(snap):
    order = np.argsort(snap["keys"])
    return snap["keys"][order], snap["values"][order], snap["state"][order]


@pytest.mark.parametrize("dense_opt,dense_lr,sparse_opt,threshold", [
    ("adam", 1e-3, "adagrad", 0.0),    # the flagship
    ("sgd", 0.05, "adam", 2.0),
])
def test_five_steps_match_jax(dense_opt, dense_lr, sparse_opt, threshold):
    (jfs, jt, js), (pfs, pt, ps) = worlds(
        dense_opt, dense_lr, optimizer=sparse_opt, learning_rate=0.05,
        embedx_threshold=threshold)
    for batch in make_batches(0, 5):
        *js, jloss, jpreds = jfs(*js, *batch)
        *ps, loss, preds = pfs(*ps, *batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds),
                                   rtol=1e-5, atol=1e-6)
    for got, want in zip(flax_leaves_from_deepfm(ps[0]), leaves_of(js[0])):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    jk, jv, jst = by_key(jt.snapshot())
    pk, pv, pst = by_key(pt.snapshot())
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pst, jst, rtol=0, atol=1e-6)
    for f in ("count", "label_sum"):
        assert float(ps[2][f]) == float(js[2][f])
    assert not bool(pfs.bad_flag)


def test_step_launches_each_kernel_path_once_and_predicts():
    """On the CPU the step takes each kernel's plain version (the CUDA
    launch counts stay 0); predict matches the reference's."""
    (jfs, jt, js), (pfs, pt, ps) = worlds("adam", 1e-3, embedx_threshold=0.0)
    batches = make_batches(1, 2)
    *js, _, _ = jfs(*js, *batches[0])
    *ps, _, _ = pfs(*ps, *batches[0])
    assert seqpool_kernel.seqpool_cvm_grad_cuda.launches == 0
    assert sparse_push.sparse_push_cuda.launches == 0
    keys, segs, cvm, _, dense, _ = batches[1]
    got = pfs.predict(ps[0], keys, segs, cvm, dense)
    want = jfs.predict(js[0], keys, segs, cvm, dense)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


needs_native = pytest.mark.skipif(not ref_native.available(),
                                  reason="native backend unavailable")
DP_TABLE = dict(embedx_dim=EDIM, cvm_offset=3, embedx_threshold=0.0,
                initial_range=0.05, seed=11)
DP_VOCAB = 1300  # keys above the 1000 prepopulated rows are new


def device_prep_worlds():
    """The reference's device-prep step over a native table of 1000
    prepopulated rows, and the port's device-prep and host-prep steps over
    native tables holding the same arena and rows, from the same weights."""
    tconf = dict(dense_optimizer="adam", dense_learning_rate=1e-3)
    jt = JaxDeviceTable(JaxTableConfig(**DP_TABLE), capacity=1 << 12,
                        backend="native", index_threads=1)
    jt.prepopulate(1000)
    jfs = JaxStep(FlaxDeepFM(hidden=HIDDEN), jt, JaxTrainerConfig(**tconf),
                  B, S, dense_dim=DD, num_auc_buckets=AUC_BUCKETS,
                  device_prep=True)
    jp, jo = jfs.init(jax.random.PRNGKey(5))
    ports = []
    for device_prep in (True, False):
        pt = DeviceTable(TableConfig(**DP_TABLE), capacity=1, device="cpu",
                         backend="native", index_threads=1)
        pt.load_arena(np.asarray(jt.values), np.asarray(jt.state),
                      jt._index.dump_keys(jt._size))
        pfs = FusedTrainStep(deepfm_from_flax_leaves(leaves_of(jp), HIDDEN),
                             pt, TrainerConfig(**tconf), B, S, dense_dim=DD,
                             num_auc_buckets=AUC_BUCKETS,
                             device_prep=device_prep)
        ports.append((pfs, pt, [*pfs.init(), pfs.init_auc_state()]))
    return (jfs, jt, [jp, jo, jfs.init_auc_state()]), ports


def assert_rows_close(pt, jt, atol):
    assert len(pt) == len(jt)
    n = len(pt) + 1
    pv, jv = pt.values[:n].numpy(), np.asarray(jt.values)[:n]
    np.testing.assert_array_equal(pv[:, :2], jv[:, :2])
    np.testing.assert_allclose(pv, jv, rtol=0, atol=atol)
    np.testing.assert_allclose(pt.state[:n].numpy(),
                               np.asarray(jt.state)[:n], rtol=0, atol=atol)


@needs_native
def test_step_device_matches_jax():
    """Four device-prep steps whose batches hold new keys ("ensure" mode
    inserts them before the step): loss, dense params and every row within
    1e-5 of the reference's ``step_device``."""
    (jfs, jt, js), ((pfs, pt, ps), _) = device_prep_worlds()
    for batch in make_batches(7, 4, vocab=DP_VOCAB):
        *js, jloss, jpreds = jfs.step_device(*js, *batch)
        *ps, loss, preds = pfs.step_device(*ps, *batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds),
                                   rtol=0, atol=1e-5)
    assert len(pt) > 1000
    for got, want in zip(flax_leaves_from_deepfm(ps[0]), leaves_of(js[0])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert_rows_close(pt, jt, 1e-5)
    np.testing.assert_array_equal(pt.row_keys()[1:],
                                  jt._index.dump_keys(jt._size)[1:])
    assert not bool(pfs.bad_flag)
    assert device_index_kernel.device_dedup_cuda.launches == 0
    assert device_index_kernel.device_probe_cuda.launches == 0


@needs_native
def test_step_device_matches_host_prep():
    """The port's two entries on the same batches (new keys included) give
    the same rows to the same keys and train alike."""
    _, ((dfs, dt, ds), (hfs, ht, hs)) = device_prep_worlds()
    for batch in make_batches(8, 4, vocab=DP_VOCAB):
        *ds, dloss, _ = dfs.step_device(*ds, *batch)
        *hs, hloss, _ = hfs(*hs, *batch)
        np.testing.assert_allclose(float(dloss), float(hloss), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(dt.row_keys(), ht.row_keys())
    for a, b in zip(ds[0].parameters(), hs[0].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-5)
    n = len(dt) + 1
    np.testing.assert_array_equal(dt.values[:n, :2], ht.values[:n, :2])
    np.testing.assert_allclose(dt.values[:n].numpy(), ht.values[:n].numpy(),
                               rtol=0, atol=1e-5)


def test_step_device_needs_device_prep():
    table = DeviceTable(TableConfig(embedx_dim=EDIM), capacity=16,
                        device="cpu", backend="numpy")
    fs = FusedTrainStep(torch.nn.Linear(1, 1), table, TrainerConfig(), B, S)
    with pytest.raises(RuntimeError, match="device_prep=True"):
        fs.step_device(None, None, None, *make_batches(0, 1)[0])
    with pytest.raises(RuntimeError, match="backend='native'"):
        FusedTrainStep(torch.nn.Linear(1, 1), table, TrainerConfig(), B, S,
                       device_prep=True)
    with pytest.raises(ValueError, match="insert_mode"):
        FusedTrainStep(torch.nn.Linear(1, 1), table, TrainerConfig(), B, S,
                       insert_mode="eager")


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "adagrad"])
def test_dense_optimizer_matches_optax(name):
    """Three steps of random grads on a small module; optax's adagrad
    starts its accumulator at 0.1 with eps inside the sqrt."""
    rng = np.random.default_rng(4)
    conf = TrainerConfig(dense_optimizer=name, dense_learning_rate=0.01,
                         dense_weight_decay=0.1)
    jconf = JaxTrainerConfig(dense_optimizer=name, dense_learning_rate=0.01,
                             dense_weight_decay=0.1)
    model = torch.nn.Linear(5, 3)
    params = [p.detach().numpy().copy() for p in model.parameters()]
    opt, jopt = make_dense_optimizer(conf), jax_dense_optimizer(jconf)
    state, jstate = opt.init(model), jopt.init(params)
    for _ in range(3):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        for p, g in zip(model.parameters(), grads):
            p.grad = torch.from_numpy(g.copy())
        state = opt.update(model, state)
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
    for p, want in zip(model.parameters(), params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_masked_loss_matches_optax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=16).astype(np.float32) * 3
    labels = (rng.uniform(size=16) < 0.5).astype(np.float32)
    mask = (rng.uniform(size=16) < 0.7).astype(np.float32)
    loss, preds = masked_bce_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask))
    want = (optax.sigmoid_binary_cross_entropy(logits, labels) * mask).sum() \
        / max(mask.sum(), 1.0)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    np.testing.assert_allclose(preds.numpy(), np.asarray(
        jax.nn.sigmoid(logits)), rtol=1e-6)
    zero, _ = masked_bce_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels), torch.zeros(16))
    assert float(zero) == 0.0


def test_unported_options_raise():
    table = DeviceTable(TableConfig(embedx_dim=EDIM), capacity=16,
                        device="cpu")
    model = torch.nn.Linear(1, 1)
    for bad in ({"dense_optimizer": "lars"}, {"dense_optimizer": "lamb"},
                {"grad_merge_steps": 2}, {"bf16": True},
                {"recompute": True}, {"dense_sync_steps": 4},
                {"metrics": ["auc", "mae"]}, {"num_devices": 4},
                {"profile": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            FusedTrainStep(model, table, TrainerConfig(**bad), B, S)
    with pytest.raises(NotImplementedError, match="ROADMAP A.3b"):
        FusedTrainStep(model, table, TrainerConfig(), B, S, device_prep=True,
                       insert_mode="deferred")


def test_widedeep_converter_round_trips_flax():
    model = FlaxWideDeep(hidden=(8, 4))
    params = model.init(jax.random.PRNGKey(1), np.zeros((2, 3, 7), np.float32),
                        np.zeros((2, 2), np.float32))
    leaves = [(np.random.default_rng(i).normal(size=np.shape(x)) * 0.1)
              .astype(np.float32) for i, x in
              enumerate(jax.tree_util.tree_leaves(params))]
    params = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), leaves)
    port = widedeep_from_flax_leaves(leaves, (8, 4))
    for got, want in zip(flax_leaves_from_widedeep(port), leaves):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(2)
    sparse = rng.normal(size=(4, 3, 7)).astype(np.float32)
    dense = rng.normal(size=(4, 2)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(sparse), torch.from_numpy(dense))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(model.apply(params, sparse, dense)),
                               rtol=1e-5, atol=1e-6)


def test_widedeep_reaches_auc_on_criteo(tmp_path):
    """Torch port of tests/test_criteo_golden.py::test_widedeep_reaches_auc:
    Wide&Deep (64, 32) on the synthetic Criteo file, B=256, 3 epochs, AUC
    of the last epoch > 0.70."""
    GB = 256
    path = str(tmp_path / "train.txt")
    make_synthetic_criteo(path, GB * 40, seed=5)
    conf = TableConfig(embedx_dim=8, cvm_offset=3, optimizer="adagrad",
                       learning_rate=0.1, embedx_threshold=0.0,
                       initial_range=0.01, seed=3)
    table = DeviceTable(conf, capacity=1 << 16, device="cpu")
    flax_model = FlaxWideDeep(hidden=(64, 32))
    params = flax_model.init(jax.random.PRNGKey(0),
                             np.zeros((GB, N_CAT, conf.pull_dim), np.float32),
                             np.zeros((GB, N_DENSE), np.float32))
    fs = FusedTrainStep(widedeep_from_flax_leaves(leaves_of(params),
                                                  (64, 32)),
                        table, TrainerConfig(dense_learning_rate=2e-3),
                        batch_size=GB, num_slots=N_CAT, dense_dim=N_DENSE,
                        num_auc_buckets=1 << 16)
    state = [*fs.init(), fs.init_auc_state()]
    reader = CriteoReader(GB)
    calc = AucCalculator(1 << 16)
    for epoch in range(3):
        for b in reader.stream([path]):
            cvm = np.stack([np.ones(GB, np.float32), b.labels], axis=1)
            *state, loss, preds = fs(*state, b.keys, b.segment_ids, cvm,
                                     b.labels, b.dense, b.row_mask())
            if epoch == 2:
                m = b.row_mask().astype(bool)
                calc.add_batch(preds.numpy()[m], b.labels[m])
    auc = calc.compute()["auc"]
    assert auc > 0.70, auc
