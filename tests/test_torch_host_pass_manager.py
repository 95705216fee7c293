"""Port's day/pass loop over the host-table engine: ``PassManager`` over
``SparsePS`` over a host ``EmbeddingTable`` (numpy backend, the same key-
deterministic init in both packages), driving
``CTRTrainer(use_device_table=False)`` as ``examples/02_deepfm_stream.py``
drives it: day 1 of two passes (the second preloaded, its keys
prefetched), each ended with a delta save, then a base save with the dense
state; day 2 of one pass with a delta; the same loop through the JAX
package from the same converted params.

Held to the reference: the donefile records and each dir's files, every
npz (keys and show/clk exact, the rest rtol 1e-5, atol 1e-6: three passes
of float32 training in another order), and ``resume`` of either package's
trail by either package, exactly (rows by key, dense leaves, version)."""

import dataclasses
import os

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
from paddlebox_tpu.ps.server import SparsePS as RefSparsePS
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu.trainer.pass_manager import PassManager as RefPassManager
from paddlebox_tpu.utils.checkpoint import pytree_arrays
from paddlebox_tpu_torch.config import (DataFeedConfig, TableConfig,
                                        TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer import donefile
from paddlebox_tpu_torch.trainer.pass_manager import PassManager
from paddlebox_tpu_torch.trainer.train_step import make_dense_optimizer
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
from paddlebox_tpu_torch.utils.checkpoint import dense_arrays

HIDDEN = (16,)
TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.05, embedx_threshold=0.0, show_clk_decay=0.9,
             seed=2)
TOL = dict(rtol=1e-5, atol=1e-6)
DAY1, DAY2 = "20260101", "20260102"


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


def port_feed_conf():
    return DataFeedConfig.from_dict(dataclasses.asdict(jax_feed_conf()))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_pass_slots")
    return [make_slot_file(str(d / f"part-{i}"), jax_feed_conf(), 24,
                           seed=30 + i, vocab=vocab)
            for i, vocab in enumerate((300, 300, 600))]


def drive(pm, tr, files):
    pm.set_date(DAY1)
    ds = pm.begin_pass(files[0:1])
    pm.preload_next(files[1:2])
    pm.prefetch_feed_next()
    tr.train_from_dataset(ds)
    pm.end_pass(save_delta=True)
    tr.reset_metrics()
    ds = pm.begin_pass([], preloaded=True)
    tr.train_from_dataset(ds)
    pm.end_pass(save_delta=True)
    pm.save_base(dense_state=(tr.params, tr.opt_state))
    pm.set_date(DAY2)
    ds = pm.begin_pass(files[2:3])
    tr.train_from_dataset(ds)
    pm.end_pass(save_delta=True)
    pm.barrier()
    pm.close()


@pytest.fixture(scope="module")
def trails(tmp_path_factory, files):
    d = tmp_path_factory.mktemp("host_loops")
    jt = JaxTable(JaxTableConfig(**TABLE), backend="numpy")
    jtr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=HIDDEN), jax_feed_conf(), JaxTableConfig(**TABLE),
        JaxTrainerConfig(), table=jt)
    assert not jtr.fused
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtr.params)]
    drive(RefPassManager(RefSparsePS({"embedding": jt}), str(d / "ref"),
                         [JaxSlotDataset(jax_feed_conf()),
                          JaxSlotDataset(jax_feed_conf())]), jtr, files)
    tr = CTRTrainer(deepfm_from_flax_leaves(leaves, HIDDEN),
                    port_feed_conf(), TableConfig(**TABLE), TrainerConfig(),
                    use_device_table=False, device="cpu")
    tr.table = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    assert not tr.fused
    drive(PassManager(SparsePS({"embedding": tr.table}), str(d / "port"),
                      [SlotDataset(port_feed_conf()),
                       SlotDataset(port_feed_conf())]), tr, files)
    return {"ref": (str(d / "ref"), jtr), "port": (str(d / "port"), tr)}


def records(root):
    return [(r["kind"], r["day"], r["pass_id"],
             os.path.relpath(r["path"], root))
            for r in donefile.read_done(root)]


def test_host_trail_matches_reference(trails):
    ref_root, port_root = trails["ref"][0], trails["port"][0]
    want = [("delta", DAY1, 1, f"{DAY1}/00001/delta"),
            ("delta", DAY1, 2, f"{DAY1}/00002/delta"),
            ("base", DAY1, 2, f"{DAY1}/00002/base"),
            ("delta", DAY2, 3, f"{DAY2}/00003/delta")]
    assert records(port_root) == records(ref_root) == want
    for _, _, _, rel in want:
        a, b = os.path.join(port_root, rel), os.path.join(ref_root, rel)
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for name in os.listdir(a):
            if not name.endswith(".npz"):
                continue
            with np.load(os.path.join(a, name)) as got, \
                    np.load(os.path.join(b, name)) as exp:
                assert sorted(got.files) == sorted(exp.files), name
                for k in exp.files:
                    assert got[k].dtype == exp[k].dtype, (rel, name, k)
                    if k in ("keys", "embedx_ok"):
                        np.testing.assert_array_equal(got[k], exp[k])
                    elif k == "values":
                        np.testing.assert_array_equal(got[k][:, :2],
                                                      exp[k][:, :2])
                    np.testing.assert_allclose(
                        got[k], exp[k], err_msg=f"{rel}/{name}:{k}", **TOL)


def host_rows(t):
    snap = t.snapshot(reset_dirty=False)
    order = np.argsort(snap["keys"])
    return [snap[k][order] for k in ("keys", "values", "state",
                                     "embedx_ok")]


@pytest.mark.parametrize("trail", ["ref", "port"])
def test_host_resume_across_packages(trail, trails):
    """The trail of ``trail`` resumed by both packages into fresh host
    tables: the version, the rows by key and the dense leaves exact; a
    new delta after the resume holds the same keys in both."""
    root = trails[trail][0]
    pt = EmbeddingTable(TableConfig(**TABLE), backend="numpy")
    model = DeepFM(3 * 7 + 3, HIDDEN)
    template = (model, make_dense_optimizer(TrainerConfig()).init(model))
    pm = PassManager(SparsePS({"embedding": pt}), root,
                     [SlotDataset(port_feed_conf())])
    pv = pm.resume(dense_template=template)
    pm.close()
    jt = JaxTable(JaxTableConfig(**TABLE), backend="numpy")
    rpm = RefPassManager(RefSparsePS({"embedding": jt}), root,
                         [JaxSlotDataset(jax_feed_conf())])
    jtr = trails["ref"][1]
    rv = rpm.resume(dense_template=(jtr.params, jtr.opt_state))
    rpm.close()
    assert pv[:2] == rv[:2] == (DAY2, 3)
    for a, b in zip(host_rows(pt), host_rows(jt)):
        np.testing.assert_array_equal(a, b)
    got, want = dense_arrays(pv[2]), pytree_arrays(rv[2])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(np.sort(pt.snapshot_delta()["keys"]),
                                  np.sort(jt.snapshot_delta()["keys"]))
