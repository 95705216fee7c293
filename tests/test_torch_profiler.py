"""The port's per-section step profile (``paddlebox_tpu_torch/trainer/
profiler.py``), the four cases of the reference's ``tests/
test_profiler.py`` carried over, on host prep and on device prep: every
section present and positive, the arenas restored bit for bit at their
addresses, the training state untouched, and the trainer's profile line
(and pass heartbeat) with the sections, the pass bit for bit with a
profile=False twin."""

import copy
import json

import numpy as np
import pytest
import torch

from conftest import make_slot_file
from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        SlotConfig, TableConfig,
                                        TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
from paddlebox_tpu_torch.trainer.profiler import (format_sections,
                                                  profile_sections)
from paddlebox_tpu_torch.trainer.step_graph import state_tensors
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer

SECTIONS = ("host_prepare_ms", "pull_ms", "forward_ms", "backward_ms",
            "forward_backward_ms", "dense_update_ms", "sparse_push_ms",
            "auc_update_ms", "step_total_ms")
CONF = dict(embedx_dim=4, cvm_offset=3, learning_rate=0.1,
            embedx_threshold=0.0, initial_range=0.02, seed=1)


def _setup(device_prep, B=32, S=3):
    torch.manual_seed(0)
    table = DeviceTable(TableConfig(**CONF), capacity=1024,
                        uniq_buckets=BucketSpec(min_size=128), device="cpu",
                        backend="native", index_threads=1)
    fstep = FusedTrainStep(DeepFM(S * 7, (16,)), table,
                           TrainerConfig(dense_learning_rate=1e-2),
                           batch_size=B, num_slots=S,
                           device_prep=device_prep)
    params, opt = fstep.init()
    auc = fstep.init_auc_state()
    rng = np.random.default_rng(0)
    keys = np.zeros(256, np.uint64)
    segs = np.full(256, B * S, np.int32)
    n = 150
    keys[:n] = rng.integers(1, 500, size=n)
    segs[:n] = np.sort(rng.integers(0, B * S, size=n)).astype(np.int32)
    labels = rng.integers(0, 2, size=B).astype(np.float32)
    cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
    return (fstep, params, opt, auc, keys, segs, cvm, labels,
            np.zeros((B, 0), np.float32), np.ones(B, np.float32))


@pytest.mark.parametrize("device_prep", [False, True])
def test_all_sections_present_and_positive(device_prep):
    fstep, params, opt, auc, *args = _setup(device_prep)
    sections = profile_sections(fstep, params, opt, auc, *args, iters=2)
    assert sorted(sections) == sorted(SECTIONS)
    for k in SECTIONS:
        assert sections[k] >= 0.0, (k, sections)
    assert sections["step_total_ms"] > 0.0
    assert sections["forward_backward_ms"] > 0.0
    line = format_sections(sections)
    assert "step_total=" in line and "pull=" in line


@pytest.mark.parametrize("device_prep", [False, True])
def test_table_arenas_restored(device_prep):
    """The step_total loop runs real pushes; the profiler puts the arenas
    (and the device dirty bitmap) back, in place."""
    fstep, params, opt, auc, *args = _setup(device_prep)
    t = fstep.table
    t.prepare_batch(args[0])          # the keys inserted up front
    before = [(x.data_ptr(), x.clone()) for x in
              (t.values, t.state, t.dirty_dev) if x is not None]
    profile_sections(fstep, params, opt, auc, *args, iters=2)
    after = [x for x in (t.values, t.state, t.dirty_dev) if x is not None]
    assert len(after) == len(before) == (3 if device_prep else 2)
    for (ptr, was), now in zip(before, after):
        assert now.data_ptr() == ptr and torch.equal(now, was)


@pytest.mark.parametrize("device_prep", [False, True])
def test_does_not_corrupt_training_state(device_prep):
    """The caller's params, optimizer and AUC state are untouched, and
    still drive a real step."""
    fstep, params, opt, auc, *args = _setup(device_prep)
    p0 = [p.detach().clone() for p in params.parameters()]
    o0 = [x.clone() for x in state_tensors(opt)]
    a0 = {k: v.clone() for k, v in auc.items()}
    profile_sections(fstep, params, opt, auc, *args, iters=2)
    assert all(torch.equal(a, b) for a, b in zip(p0, params.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(o0, state_tensors(opt)))
    assert all(torch.equal(a0[k], auc[k]) for k in auc)
    entry = fstep.step_device if device_prep else fstep
    out = entry(params, opt, auc, *args)
    assert np.isfinite(float(out[3]))


def test_trainer_profile_line_includes_sections(capsys, tmp_path,
                                                monkeypatch):
    feed_conf = DataFeedConfig(
        slots=[SlotConfig(name="label", type="float")] +
              [SlotConfig(name=f"s{i}") for i in range(3)],
        batch_size=16)
    p = str(tmp_path / "part-0")
    make_slot_file(p, feed_conf, 32, seed=0)
    ds = SlotDataset(feed_conf)
    ds.set_filelist([p])
    ds.load_into_memory()
    conf = TableConfig(embedx_dim=4, cvm_offset=3, embedx_threshold=0.0)
    torch.manual_seed(0)
    model = DeepFM(3 * 7, (8,))
    hb = tmp_path / "hb.jsonl"
    trainers = []
    for profile in (True, False):
        monkeypatch.setenv("PBOX_FLAGS_obs_heartbeat_path",
                           str(hb) if profile else "")
        table = DeviceTable(conf, capacity=512, device="cpu",
                            backend="native", index_threads=1)
        tr = CTRTrainer(copy.deepcopy(model), feed_conf, conf,
                        TrainerConfig(profile=profile), table=table)
        trainers.append((tr, tr.train_from_dataset(ds)))
        if profile:
            err = capsys.readouterr().err
            assert "log_for_profile" in err
            assert "sections[" in err and "step_total=" in err
    (rec,) = [json.loads(x) for x in open(hb)]
    assert sorted(rec["sections"]) == sorted(SECTIONS)
    (a, ma), (b, mb) = trainers
    assert ma == mb
    assert all(torch.equal(x, y) for x, y in zip(a.params.parameters(),
                                                 b.params.parameters()))
    assert torch.equal(a.table.values, b.table.values)
    assert torch.equal(a.table.state, b.table.state)
    assert torch.equal(a.table.dirty_dev, b.table.dirty_dev)
