"""The port's data-parallel step over a host table
(``paddlebox_tpu_torch/parallel/dp_step.py`` ``ShardedTrainStep``) on CPU
meshes in one process, against the JAX package on its virtual CPU devices
(``tests/conftest.py``). Each package's ``EmbeddingTable(backend=
"numpy")`` pulls every shard's keys with one flat ``pull`` and takes the
step's grads with one flat ``push``; the dense weights are the
reference's flax init, converted; the batches are ``split_batch``es of
the same seeded batches, with one bucket.

- one shard: bit for bit with the port's ``TrainStep`` on the same
  arrays, and within 1e-6 of the reference's ``ShardedTrainStep``;
- 2 and 4 shards, sync DP: within 1e-5 (rtol and atol: float32 sums in
  another order) of the reference's single-device ``TrainStep`` on the
  merged batch and of the reference's ``ZeroShardedTrainStep``. Not of the
  reference's sync ``ShardedTrainStep`` at more than one shard, which
  sums the replicated params' gradients ~ndev times over in this JAX
  (ROADMAP C.0);
- LocalSGD (``dense_sync_steps=2``) within 1e-5 of the reference's
  LocalSGD, the replicas equal after a sync;
- the AUC counts every row, and each shard's ``demb`` is the merged
  batch's on its keys (1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.data.batch import CsrBatch as JaxCsrBatch
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.parallel.dp_step import \
    stack_batches as jax_stack_batches
from paddlebox_tpu.trainer.train_step import TrainStep as JaxTrainStep
from paddlebox_tpu_torch.config import BucketSpec, TableConfig
from paddlebox_tpu_torch.data.batch import CsrBatch
from paddlebox_tpu_torch.parallel import dp_step
from paddlebox_tpu_torch.parallel.dp_step import split_batch, stack_batches
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer.train_step import TrainStep
from torch_dp_worlds import (ATOL, B, BUCKET, HIDDEN, RTOL, S, STEPS, TABLE,
                             assert_tables, batch_kw, batches, cvm_of,
                             flax_init, leaves_of, port_leaves, port_model,
                             run_port, run_ref_sharded, run_ref_single,
                             tconf)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_shard_is_train_step_bit_for_bit():
    """At one shard every sum is the identity: the step is ``TrainStep``
    on the same arrays, bit for bit (loss, preds, demb, params, AUC)."""
    _, leaves = flax_init()
    kws = batches(0)
    got, params, _, auc, ct, table, _ = run_port(1, kws, tconf(), leaves)
    ts = TrainStep(port_model(leaves), TableConfig(**TABLE), tconf(), B, S,
                   device="cpu")
    tp, to = ts.init()
    ta = ts.init_auc_state()
    tt = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    for kw, g in zip(kws, got):
        sb = g["sb"]
        emb = tt.pull(sb.keys[0])
        tp, to, ta, demb, loss, preds = ts(
            tp, to, ta, emb, sb.segment_ids[0], cvm_of(sb.labels[0]),
            sb.labels[0], sb.dense[0], sb.row_mask[0])
        tt.push(sb.keys[0], demb)
        assert float(loss) == g["loss"]
        np.testing.assert_array_equal(preds.numpy(), g["preds"])
        np.testing.assert_array_equal(demb, g["demb"][0])
    for a, b in zip(params.parameters(), tp.parameters()):
        assert torch.equal(a, b)
    for k in auc:
        assert torch.equal(auc[k], ta[k])
    assert int(ct) == STEPS
    assert_tables(table, tt, rtol=0, atol=0)


def test_one_shard_matches_reference_sharded_step():
    _, leaves = flax_init()
    kws = batches(1)
    got, params, *_, table, _ = run_port(1, kws, tconf(), leaves)
    want, wparams, _, wtable = run_ref_sharded(1, kws, tconf(ref=True))
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-6
        np.testing.assert_allclose(g["preds"], w["preds"], rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(port_leaves(params), leaves_of(wparams)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert_tables(table, wtable, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ndev", [2, 4])
def test_sync_matches_single_device_and_reference_zero(ndev):
    """Sync DP over ``ndev`` shards against the reference's single-device
    step on the merged batch (losses, preds, demb on each shard's keys,
    params, rows) and the reference's ZeRO step at ``ndev`` devices (its
    materialized params, losses)."""
    jparams, leaves = flax_init()
    kws = batches(2)
    got, params, _, auc, _, table, _ = run_port(ndev, kws, tconf(), leaves)
    want, wparams, wtable = run_ref_single(kws, tconf(ref=True), jparams)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        np.testing.assert_allclose(g["preds"], w["preds"], rtol=RTOL,
                                   atol=ATOL)
        sb = g["sb"]
        n = sb.num_keys
        off = np.concatenate([[0], np.cumsum(n)])
        for d in range(ndev):
            np.testing.assert_allclose(g["demb"][d, :n[d]],
                                       w["demb"][off[d]:off[d + 1]],
                                       rtol=RTOL, atol=ATOL)
            assert not g["demb"][d, n[d]:, 2:].any()
    for a, b in zip(port_leaves(params), leaves_of(wparams)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert_tables(table, wtable)
    zwant, zparams, _, _ = run_ref_sharded(ndev, kws, tconf(ref=True),
                                           zero=True)
    for g, w in zip(got, zwant):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
    for a, b in zip(port_leaves(params), leaves_of(zparams)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # the AUC counted every row of every shard, once a step
    counts = float(auc["pos"].sum() + auc["neg"].sum())
    assert counts == STEPS * B


@pytest.mark.parametrize("ndev", [2, 4])
def test_localsgd_matches_reference(ndev):
    """``dense_sync_steps=2``: each shard's replica steps on its own
    gradient, the replicas averaged every 2 steps; against the
    reference's LocalSGD (replica by replica), and the replicas equal
    after the sync."""
    _, leaves = flax_init()
    kws = batches(3, steps=4)
    got, reps, opt, *_ = run_port(ndev, kws, tconf(k=2), leaves)
    want, wparams, _, _ = run_ref_sharded(ndev, kws,
                                          tconf(k=2, ref=True))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        np.testing.assert_allclose(g["preds"], w["preds"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g["demb"], w["demb"], rtol=RTOL,
                                   atol=ATOL)
    assert isinstance(reps, list) and len(reps) == ndev == len(opt)
    for d, rep in enumerate(reps):
        for a, b in zip(port_leaves(rep), leaves_of(wparams)):
            np.testing.assert_allclose(a, b[d], rtol=RTOL, atol=ATOL)
        for a, b in zip(rep.parameters(), reps[0].parameters()):
            assert torch.equal(a, b)      # 4 steps: just synced


def test_localsgd_replicas_drift_between_syncs():
    _, leaves = flax_init()
    _, reps, *_ = run_port(2, batches(4, steps=3), tconf(k=2), leaves)
    diff = max(float((a - b).abs().max().detach())
               for a, b in zip(reps[0].parameters(), reps[1].parameters()))
    assert diff > 0.0


def test_predict_and_stack_batches_match_reference():
    rng = np.random.default_rng(5)
    parts = [batch_kw(rng, b=4, s=2) for _ in range(4)]
    got = stack_batches([CsrBatch(**p) for p in parts],
                        BucketSpec(min_size=BUCKET))
    want = jax_stack_batches([JaxCsrBatch(**p) for p in parts],
                             JaxBucketSpec(min_size=BUCKET))
    for f in ("keys", "segment_ids", "labels", "dense", "row_mask",
              "num_keys"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert dp_step.ShardedBatch is type(got)
    # predict of the trained step against the reference single step's
    jparams, leaves = flax_init()
    kws = batches(6, steps=2)
    _, params, _, _, _, table, st = run_port(4, kws[:1], tconf(), leaves)
    _, wparams, wtable = run_ref_single(kws[:1], tconf(ref=True), jparams)
    sb = split_batch(CsrBatch(**kws[1]), 4, BucketSpec(min_size=BUCKET))
    D = table.conf.pull_dim
    emb = table.pull(sb.flat_keys(), create=False).reshape(4, -1, D)
    got = st.predict(params, emb, sb.segment_ids, cvm_of(sb.labels),
                     sb.dense).numpy().reshape(-1)
    ref = JaxTrainStep(FlaxDeepFM(hidden=HIDDEN), JaxTableConfig(**TABLE),
                       tconf(ref=True), batch_size=B, num_slots=S)
    b = JaxCsrBatch(**kws[1])
    want = np.asarray(ref.predict(
        wparams, jnp.asarray(wtable.pull(b.keys, create=False)),
        jnp.asarray(b.segment_ids), jnp.asarray(cvm_of(b.labels)),
        jnp.asarray(b.dense)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
