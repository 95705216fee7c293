"""The port's ZeRO step (``paddlebox_tpu_torch/parallel/zero.py``
``ZeroShardedTrainStep``) on CPU meshes against the reference's
``ZeroShardedTrainStep`` on its virtual CPU devices, from the same flax
init (converted), over each package's host table (``backend="numpy"``):
losses, predictions, each shard's ``demb``, the materialized params and
the table's rows within 1e-5 (rtol and atol; float32 sums in another
order), sgd and adam, at 2 and 4 shards. The storage is sharded: each
shard holds its chunk and its chunk's state only, on its device; lamb and
lars are refused as in the reference."""

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import TableConfig as JaxTableConfig
from paddlebox_tpu.config import TrainerConfig as JaxTrainerConfig
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.parallel.zero import ZeroShardedTrainStep as JaxZero
from paddlebox_tpu_torch.config import BucketSpec, TableConfig, TrainerConfig
from paddlebox_tpu_torch.data.batch import CsrBatch
from paddlebox_tpu_torch.models.convert import flax_leaves_from_model
from paddlebox_tpu_torch.parallel.dp_step import split_batch
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.parallel.zero import ZeroShardedTrainStep
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from torch_dp_worlds import (ATOL, B, BUCKET, HIDDEN, RTOL, S, TABLE,
                             assert_tables, batches, cvm_of, flax_init,
                             leaves_of, port_model, run_ref_sharded)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_zero(ndev, kws, conf, leaves):
    mesh = make_mesh(ndev, device="cpu")
    st = ZeroShardedTrainStep(port_model(leaves), TableConfig(**TABLE),
                              conf, mesh, batch_size=B // ndev, num_slots=S)
    chunks, opt = st.init()
    auc = st.init_auc_state()
    table = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    D = table.conf.pull_dim
    out = []
    for kw in kws:
        sb = split_batch(CsrBatch(**kw), ndev, BucketSpec(min_size=BUCKET))
        emb = table.pull(sb.flat_keys()).reshape(ndev, -1, D)
        chunks, opt, auc, demb, loss, preds = st(
            chunks, opt, auc, emb, sb.segment_ids, cvm_of(sb.labels),
            sb.labels, sb.dense, sb.row_mask)
        table.push(sb.flat_keys(), demb.reshape(-1, D))
        out.append(dict(loss=float(loss), preds=preds.numpy().reshape(-1),
                        demb=demb))
    return out, st, chunks, opt, table


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("ndev", [2, 4])
def test_matches_reference_zero(ndev, opt):
    _, leaves = flax_init()
    kws = batches(10 + ndev)
    lr = 0.05 if opt == "sgd" else 1e-2
    got, st, chunks, _, table = run_zero(
        ndev, kws, TrainerConfig(dense_optimizer=opt, dense_learning_rate=lr),
        leaves)
    want, wparams, _, wtable = run_ref_sharded(
        ndev, kws, JaxTrainerConfig(dense_optimizer=opt,
                                    dense_learning_rate=lr), zero=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        np.testing.assert_allclose(g["preds"], w["preds"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g["demb"], w["demb"], rtol=RTOL,
                                   atol=ATOL)
    model = st.materialize(chunks)
    for a, b in zip(flax_leaves_from_model(model), leaves_of(wparams)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert_tables(table, wtable)


def test_storage_is_sharded():
    _, leaves = flax_init()
    ndev = 4
    model = port_model(leaves)
    total = sum(p.numel() for p in model.parameters())
    st = ZeroShardedTrainStep(model, TableConfig(**TABLE),
                              TrainerConfig(dense_optimizer="adam"),
                              make_mesh(ndev, device="cpu"),
                              batch_size=B // ndev, num_slots=S)
    chunks, opt = st.init()
    chunk = -(-total // ndev)
    assert len(chunks) == len(opt) == ndev
    assert all(c.flat.shape == (chunk,) for c in chunks)
    assert all(len(o["mu"]) == 1 and o["mu"][0].shape == (chunk,)
               for o in opt)
    # adam: a chunk, its mu and nu, and the count a shard
    assert st.shard_bytes(chunks, opt) == [4 * (3 * chunk + 1)] * ndev
    # the chunks hold the model's weights in parameters() order, padded
    flat = torch.cat([c.flat.detach() for c in chunks])
    want = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    assert torch.equal(flat[:total], want)
    assert not flat[total:].any()
    # and come back as the module
    back = st.materialize(chunks)
    for a, b in zip(back.parameters(), model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("opt", ["lamb", "lars"])
def test_non_elementwise_optimizer_refused(opt):
    _, leaves = flax_init()
    with pytest.raises(ValueError, match="elementwise optimizer"):
        ZeroShardedTrainStep(port_model(leaves), TableConfig(**TABLE),
                             TrainerConfig(dense_optimizer=opt),
                             make_mesh(2, device="cpu"), batch_size=B // 2,
                             num_slots=S)


def test_reference_zero_init_is_the_flax_init():
    """The reference's ZeRO init and its TrainStep's init draw the same
    flax params from PRNGKey(0), so both compare against one init."""
    jparams, _ = flax_init()
    z = JaxZero(FlaxDeepFM(hidden=HIDDEN), JaxTableConfig(**TABLE),
                JaxTrainerConfig(), jax_make_mesh(2), batch_size=B // 2,
                num_slots=S)
    p, _ = z.init(jax.random.PRNGKey(0))
    for a, b in zip(leaves_of(z.materialize(p)), leaves_of(jparams)):
        np.testing.assert_array_equal(a, b)
