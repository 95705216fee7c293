"""The port's ``metrics/auc_runner.py`` against the JAX package's, on the
same slot files (``conftest.make_slot_file`` at the reference tests'
``feed_conf``, two files of 48 rows): ``CandidatePool`` and
``record_replace`` draw and replace the same values and restore the
records bit for bit; ``AucRunner.slot_importance`` and
``slot_importance_pool`` over the host-table engine of each package's
``CTRTrainer`` (the reference trainer's DeepFM params converted, each
package's ``EmbeddingTable(backend="numpy")`` fed the same keys) agree
within the atol 1e-5 the trainer tests hold ``evaluate`` to, and restore
the dataset."""

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
from paddlebox_tpu.metrics import auc_runner as ref_runner
from paddlebox_tpu.models import DeepFM as FlaxDeepFM
from paddlebox_tpu.ps.table import EmbeddingTable as JaxTable
from paddlebox_tpu.trainer import trainer as ref_trainer
from paddlebox_tpu_torch.config import (DataFeedConfig, TableConfig,
                                        TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.metrics import auc_runner
from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer

TABLE = dict(embedx_dim=4, cvm_offset=3, optimizer="adagrad",
             learning_rate=0.05, embedx_threshold=0.0, initial_range=0.5,
             seed=2)
HIDDEN = (16, 8)


def jax_feed_conf():
    return JaxFeedConfig(slots=[
        JaxSlotConfig("label", type="float", is_dense=True, dim=1),
        JaxSlotConfig("slot_a"), JaxSlotConfig("slot_b"),
        JaxSlotConfig("slot_c"),
        JaxSlotConfig("dense_x", type="float", is_dense=True, dim=3),
    ], batch_size=8, label_slot="label", thread_num=2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("auc_runner")
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


def record_arrays(ds):
    return [(r.uint64_feas.copy(), r.uint64_offsets.copy())
            for r in ds.records]


def assert_records_equal(a, b):
    assert len(a) == len(b)
    for (fa, oa), (fb, ob) in zip(a, b):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(oa, ob)


def test_pool_and_replace_match_reference(files):
    jds, pds = datasets(files)
    before = record_arrays(pds)
    jpool = ref_runner.CandidatePool(16, [0, 2], seed=3)
    ppool = auc_runner.CandidatePool(16, [0, 2], seed=3)
    jpool.push(jds.records)
    ppool.push(pds.records)
    assert len(ppool) == len(jpool) == 16 and ppool.slots == [0, 2]
    for i in range(16):
        for s in (0, 2):
            np.testing.assert_array_equal(ppool.candidate(i)[s],
                                          jpool.candidate(i)[s])
    jorig = ref_runner.record_replace(jds.records, [2], jpool, seed=5)
    porig = auc_runner.record_replace(pds.records, [2], ppool, seed=5)
    assert_records_equal(record_arrays(pds), record_arrays(jds))
    assert any(not np.array_equal(a[0], b[0])
               for a, b in zip(record_arrays(pds), before))
    auc_runner.record_replace_back(pds.records, porig)
    ref_runner.record_replace_back(jds.records, jorig)
    assert_records_equal(record_arrays(pds), before)
    for bad in ([1], [0, 5]):
        with pytest.raises(ValueError, match="no candidates"):
            auc_runner.record_replace(pds.records, bad, ppool)
    with pytest.raises(ValueError, match="capacity"):
        auc_runner.CandidatePool(0, [0])
    with pytest.raises(ValueError, match="empty candidate pool"):
        auc_runner.record_replace(pds.records, [0],
                                  auc_runner.CandidatePool(4, [0]))


@pytest.fixture(scope="module")
def trainers(files):
    torch.set_num_threads(1)
    jtr = ref_trainer.CTRTrainer(
        FlaxDeepFM(hidden=HIDDEN), jax_feed_conf(),
        JaxTableConfig(**TABLE), JaxTrainerConfig(),
        table=JaxTable(JaxTableConfig(**TABLE), backend="numpy"))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtr.params)]
    tr = CTRTrainer(deepfm_from_flax_leaves(leaves, HIDDEN),
                    DataFeedConfig.from_dict(
                        dataclasses.asdict(jax_feed_conf())),
                    TableConfig(**TABLE), TrainerConfig(),
                    table=EmbeddingTable(TableConfig(**TABLE),
                                         backend="numpy"), device="cpu")
    jds, pds = datasets(files)
    # the same key-deterministic rows in both tables
    jtr.table.feed_pass(jds.extract_keys())
    tr.table.feed_pass(pds.extract_keys())
    return jtr, tr


def assert_importance_close(got, want):
    assert sorted(got) == sorted(want)
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=0, atol=1e-5,
                                   err_msg=f"slot {s}")


def test_slot_importance_matches_reference(files, trainers):
    jtr, tr = trainers
    jds, pds = datasets(files)
    before = record_arrays(pds)
    want = ref_runner.AucRunner(jtr, seed=4).slot_importance(jds)
    got = auc_runner.AucRunner(tr, seed=4).slot_importance(pds)
    assert_importance_close(got, want)
    assert any(abs(v) > 1e-3 for v in got.values())
    assert_records_equal(record_arrays(pds), before)


def test_slot_importance_pool_matches_reference(files, trainers):
    jtr, tr = trainers
    jds, pds = datasets(files)
    before = record_arrays(pds)
    phases = [[0], [1, 2]]
    want = ref_runner.AucRunner(jtr, seed=6).slot_importance_pool(
        jds, phases, pool_size=32)
    got = auc_runner.AucRunner(tr, seed=6).slot_importance_pool(
        pds, phases, pool_size=32)
    assert_importance_close(got, want)
    assert got[1] == got[2]                 # one measurement a phase
    assert_records_equal(record_arrays(pds), before)
    with pytest.raises(ValueError) as jerr:
        ref_runner.AucRunner(jtr).slot_importance_pool(jds, [[0], [0, 1]])
    with pytest.raises(ValueError) as perr:
        auc_runner.AucRunner(tr).slot_importance_pool(pds, [[0], [0, 1]])
    assert str(perr.value) == str(jerr.value)
