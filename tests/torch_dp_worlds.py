"""Worlds of the host-table mesh parity tests (``test_torch_dp_step.py``,
``test_torch_zero.py``, ``test_torch_trainer_mesh.py``): the batches, the
reference's flax DeepFM init and its conversion, and the reference's
single-device ``TrainStep``, ``ShardedTrainStep`` and
``ZeroShardedTrainStep`` over its host table on its virtual CPU
devices."""

import jax
import jax.numpy as jnp
import numpy as np

from paddlebox_tpu.config import BucketSpec as JaxBucketSpec
from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.data.batch import CsrBatch as JaxCsrBatch
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.parallel.dp_step import \
    ShardedTrainStep as JaxShardedStep
from paddlebox_tpu.parallel.dp_step import split_batch as jax_split_batch
from paddlebox_tpu.parallel.zero import ZeroShardedTrainStep as JaxZero
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer.train_step import TrainStep as JaxTrainStep
from paddlebox_tpu_torch.config import BucketSpec, TableConfig, TrainerConfig
from paddlebox_tpu_torch.data.batch import CsrBatch
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_model)
from paddlebox_tpu_torch.parallel.dp_step import (ShardedTrainStep,
                                                  split_batch)
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps.table import EmbeddingTable

B, S, VOCAB, STEPS = 16, 3, 120, 3
HIDDEN = (16,)
RTOL = ATOL = 1e-5
TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="sgd", learning_rate=0.1,
             embedx_threshold=0.0, initial_range=0.01, seed=1)
BUCKET = 256


def batch_kw(rng, b=B, s=S, npad=512):
    lengths = rng.integers(1, 4, size=(b, s)).astype(np.int32)
    n = int(lengths.sum())
    keys = np.zeros(npad, np.uint64)
    keys[:n] = rng.integers(1, VOCAB, size=n)
    segs = np.full(npad, b * s, np.int32)
    segs[:n] = np.repeat(np.arange(b * s), lengths.reshape(-1))
    return dict(keys=keys, segment_ids=segs, lengths=lengths,
                labels=rng.integers(0, 2, size=b).astype(np.float32),
                dense=np.zeros((b, 0), np.float32), batch_size=b,
                num_slots=s, num_keys=n, num_rows=b)


def batches(seed, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [batch_kw(rng) for _ in range(steps)]


def flax_init():
    """The reference's DeepFM params (one init for every world) and the
    port's model holding them."""
    step = JaxTrainStep(FlaxDeepFM(hidden=HIDDEN), JaxTableConfig(**TABLE),
                        JaxTrainerConfig(), batch_size=B, num_slots=S)
    params, _ = step.init(jax.random.PRNGKey(0))
    return params, [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def port_model(leaves):
    return deepfm_from_flax_leaves(leaves, HIDDEN)


def tconf(opt="sgd", lr=0.05, k=0, ref=False):
    cls = JaxTrainerConfig if ref else TrainerConfig
    return cls(dense_optimizer=opt, dense_learning_rate=lr,
               dense_sync_steps=k)


def cvm_of(labels):
    return np.stack([np.ones_like(labels), labels], axis=-1)


def run_ref_single(kws, conf, params):
    """The reference's single-device ``TrainStep`` on the merged batches."""
    st = JaxTrainStep(FlaxDeepFM(hidden=HIDDEN), JaxTableConfig(**TABLE),
                      conf, batch_size=B, num_slots=S)
    _, opt = st.init(jax.random.PRNGKey(0))
    auc = st.init_auc_state()
    table = JaxTable(JaxTableConfig(**TABLE), backend="numpy")
    out = []
    for kw in kws:
        b = JaxCsrBatch(**kw)
        emb = table.pull(b.keys)
        params, opt, auc, demb, loss, preds = st(
            params, opt, auc, jnp.asarray(emb), jnp.asarray(b.segment_ids),
            jnp.asarray(cvm_of(b.labels)), jnp.asarray(b.labels),
            jnp.asarray(b.dense), jnp.asarray(b.row_mask()))
        table.push(b.keys, np.asarray(demb))
        out.append(dict(loss=float(loss), preds=np.asarray(preds),
                        demb=np.asarray(demb)))
    return out, params, table


def run_ref_sharded(ndev, kws, conf, zero=False):
    """The reference's ``ShardedTrainStep`` (or ``ZeroShardedTrainStep``)
    over ``ndev`` of its virtual devices."""
    mesh = jax_make_mesh(ndev)
    cls = JaxZero if zero else JaxShardedStep
    st = cls(FlaxDeepFM(hidden=HIDDEN), JaxTableConfig(**TABLE), conf, mesh,
             batch_size=B // ndev, num_slots=S)
    params, opt = st.init(jax.random.PRNGKey(0))
    auc = st.init_auc_state()
    ct = None if zero else st.init_step_counter()
    table = JaxTable(JaxTableConfig(**TABLE), backend="numpy")
    D = table.conf.pull_dim
    out = []
    for kw in kws:
        sb = jax_split_batch(JaxCsrBatch(**kw), ndev,
                             JaxBucketSpec(min_size=BUCKET))
        emb = jnp.asarray(table.pull(sb.flat_keys()).reshape(ndev, -1, D))
        args = (emb, jnp.asarray(sb.segment_ids),
                jnp.asarray(cvm_of(sb.labels)), jnp.asarray(sb.labels),
                jnp.asarray(sb.dense), jnp.asarray(sb.row_mask))
        if zero:
            params, opt, auc, demb, loss, preds = st(params, opt, auc,
                                                     *args)
        else:
            params, opt, auc, ct, demb, loss, preds = st(params, opt, auc,
                                                         ct, *args)
        demb = np.asarray(demb)
        table.push(sb.flat_keys(), demb.reshape(-1, D))
        out.append(dict(loss=float(loss),
                        preds=np.asarray(preds).reshape(-1), demb=demb))
    if zero:
        params = st.materialize(params)
    return out, params, auc, table


def leaves_of(params):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def port_leaves(model):
    return flax_leaves_from_model(model)


def rows(table):
    snap = table.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return [snap[k][order] for k in ("keys", "values", "state")]


def assert_tables(a, b, rtol=RTOL, atol=ATOL):
    ka, va, sa = rows(a)
    kb, vb, sb = rows(b)
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_allclose(va, vb, rtol=rtol, atol=atol)
    np.testing.assert_allclose(sa, sb, rtol=rtol, atol=atol)


def run_port(ndev, kws, conf, leaves):
    """The port's ``ShardedTrainStep`` over ``ndev`` CPU shards."""
    mesh = make_mesh(ndev, device="cpu")
    st = ShardedTrainStep(port_model(leaves), TableConfig(**TABLE), conf,
                          mesh, batch_size=B // ndev, num_slots=S)
    params, opt = st.init()
    auc, ct = st.init_auc_state(), st.init_step_counter()
    table = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    D = table.conf.pull_dim
    out = []
    for kw in kws:
        sb = split_batch(CsrBatch(**kw), ndev, BucketSpec(min_size=BUCKET))
        emb = table.pull(sb.flat_keys()).reshape(ndev, -1, D)
        params, opt, auc, ct, demb, loss, preds = st(
            params, opt, auc, ct, emb, sb.segment_ids, cvm_of(sb.labels),
            sb.labels, sb.dense, sb.row_mask)
        table.push(sb.flat_keys(), demb.reshape(-1, D))
        out.append(dict(loss=float(loss), preds=preds.numpy().reshape(-1),
                        demb=demb, sb=sb))
    return out, params, opt, auc, ct, table, st
