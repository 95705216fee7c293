"""The port's ``CTRTrainer`` with a mesh over a host table
(``mesh=make_mesh(n, device="cpu")``, ``use_device_table=False``; or
``dense_sync_steps`` > 0) against the JAX package's trainers on the same
``make_slot_file`` pass (the reference tests' ``feed_conf``: batch 8, two
files of 48 rows), ``train_from_dataset`` then ``evaluate``, each over its
package's ``EmbeddingTable(backend="numpy")`` (the same key-deterministic
init), from the reference trainer's params (converted):

- one shard against the reference's mesh trainer at one device;
- four shards against the reference's single-device host-table trainer
  (sync DP is the single-device step on the merged batch);
- ``dense_sync_steps=2`` at four shards against the reference's mesh
  trainer (LocalSGD over its virtual devices).

Per-batch loss and preds, the pass and evaluation metrics, every row by
key (show/clk exact) and the dense params within rtol 1e-5, atol 1e-6
(float32 sums in another order); the spans pull, step and push once a
batch; evaluation creates no rows."""

import dataclasses

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
from paddlebox_tpu.parallel import make_mesh as jax_make_mesh
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu_torch.config import (DataFeedConfig, TableConfig,
                                        TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_model)
from paddlebox_tpu_torch.parallel.dp_step import ShardedTrainStep
from paddlebox_tpu_torch.parallel.mesh import make_mesh
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer

HIDDEN = (16,)
TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.05, embedx_threshold=0.0, seed=2)
STEPS = 12
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_feed_conf():
    return JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=3),
    ], batch_size=8, label_slot="label", thread_num=2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer_mesh_slots")
    return [make_slot_file(str(d / f"part-{i}"), jax_feed_conf(), 48,
                           seed=i) for i in range(2)]


def datasets(files):
    jds = JaxSlotDataset(jax_feed_conf())
    pds = SlotDataset(DataFeedConfig.from_dict(
        dataclasses.asdict(jax_feed_conf())))
    for ds in (jds, pds):
        ds.set_filelist(files)
        ds.load_into_memory()
    return jds, pds


def leaves(params, replica=False):
    out = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    return [x[0] for x in out] if replica else out


def rows(table):
    snap = table.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return [snap[k][order] for k in ("keys", "values", "state",
                                     "embedx_ok")]


def run_pair(files, jmesh, ndev, tconf):
    """The reference trainer (a mesh of ``jmesh`` devices, or none) and the
    port's over ``ndev`` CPU shards, each through a pass and an
    evaluation; returns what each gave."""
    jtr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=HIDDEN), jax_feed_conf(), JaxTableConfig(**TABLE),
        JaxTrainerConfig(**dataclasses.asdict(tconf)),
        table=JaxTable(JaxTableConfig(**TABLE), backend="numpy"),
        mesh=None if not jmesh else jax_make_mesh(jmesh))
    model = deepfm_from_flax_leaves(
        leaves(jtr.params, replica=bool(jmesh) and tconf.dense_sync_steps > 0),
        HIDDEN)
    tr = CTRTrainer(model, DataFeedConfig.from_dict(
        dataclasses.asdict(jax_feed_conf())), TableConfig(**TABLE), tconf,
        mesh=make_mesh(ndev, device="cpu"), use_device_table=False)
    assert isinstance(tr.step, ShardedTrainStep) and not tr.fused
    tr.table = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    jds, pds = datasets(files)
    want_fetched, fetched = [], []
    want = jtr.train_from_dataset(jds, fetch_handler=lambda s, l, p:
                                  want_fetched.append((s, l, np.asarray(p))))
    got = tr.train_from_dataset(pds, fetch_handler=lambda s, l, p:
                                fetched.append((s, l, np.asarray(p))))
    assert [s for s, _, _ in fetched] == [s for s, _, _ in want_fetched]
    for (_, loss, preds), (_, jloss, jpreds) in zip(fetched, want_fetched):
        np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(preds.reshape(-1), jpreds.reshape(-1),
                                   rtol=RTOL, atol=ATOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert got["ins_num"] == 96.0
    g, w = rows(tr.table), rows(jtr.table)
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(g[1][:, :2], w[1][:, :2])
    for a, b in zip(g[1:3], w[1:3]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for span in ("main", "pull", "step", "push"):
        assert tr.timer.count[span] == STEPS
    size = len(tr.table)
    ev, jev = tr.evaluate(pds), jtr.evaluate(jds)
    for k in jev:
        np.testing.assert_allclose(ev[k], jev[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert len(tr.table) == size
    return tr, jtr


def test_one_shard_matches_reference_mesh_trainer(files):
    tr, jtr = run_pair(files, 1, 1, TrainerConfig())
    for a, b in zip(flax_leaves_from_model(tr.params), leaves(jtr.params)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert int(tr._step_counter) == STEPS


def test_four_shards_match_reference_single_device_trainer(files):
    tr, jtr = run_pair(files, 0, 4, TrainerConfig())
    assert not isinstance(tr.params, list)
    for a, b in zip(flax_leaves_from_model(tr.params), leaves(jtr.params)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_local_sgd_matches_reference_mesh_trainer(files):
    tconf = TrainerConfig(dense_optimizer="sgd", dense_learning_rate=0.05,
                          dense_sync_steps=2)
    tr, jtr = run_pair(files, 4, 4, tconf)
    assert isinstance(tr.params, list) and len(tr.params) == 4
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtr.params)]
    for d, rep in enumerate(tr.params):
        for a, b in zip(flax_leaves_from_model(rep), want):
            np.testing.assert_allclose(a, b[d], rtol=RTOL, atol=ATOL)
