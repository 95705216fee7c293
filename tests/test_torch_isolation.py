"""The port stands alone: no jax, flax, optax or paddlebox_tpu import, in the
package, in chip_smoke.py, kernel_versions.py, pass_versions.py or
guard_cost.py; it serves, trains and runs a trainer pass, from a dataset
and straight off files, a day/pass loop with its checkpoints and resume,
and that loop over a tiered table with its host backing and prefetched feed
pass, and the host-table engine with an MMoE step, a step over an int8
arena, the disk ladder with the dense lars, lamb and gradient merging and
the cvm ops, and the multi-process reader over both protocols with the
error budget and the archive, and a staged device-feed pass with its trace
and heartbeat, and a guarded pass with a rollback, a profiled pass and a
postmortem bundle, and a process-scope serving fleet whose spawned child
builds its own predictor, and the host tier's resolver and LB over a
scripted host, and the CTR dense ops with a page-view batch and an
AucRunner, and a trainer pass and a predictor through a 2-shard PS
service, with them blocked (in the child too); its entry
points default to the card and raise without one (the trainer and the
serving tier too); its kernel modules import without a CUDA toolkit; the
serving tier's batcher and transport import neither torch nor numpy."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "paddlebox_tpu_torch")
FORBIDDEN = {"jax", "flax", "optax", "paddlebox_tpu"}


def _port_files():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                           "kernel_versions.py",
                                           "pass_versions.py",
                                           "guard_cost.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=240, env=env)


def test_no_forbidden_imports_in_source():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert len(_port_files()) > 15
    assert not bad, bad


def test_imports_and_serves_with_jax_blocked(tmp_path):
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import pkgutil, importlib
        import paddlebox_tpu_torch
        for m in pkgutil.walk_packages(paddlebox_tpu_torch.__path__,
                                       "paddlebox_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        import numpy as np
        from paddlebox_tpu_torch.config import TableConfig
        from paddlebox_tpu_torch.data.criteo import (
            CriteoReader, criteo_feed_config, make_synthetic_criteo)
        from paddlebox_tpu_torch.inference import (
            load_inference_model, save_inference_model)
        from paddlebox_tpu_torch.models import DeepFM
        rng = np.random.default_rng(0)
        data = {str(tmp_path / 'c.txt')!r}
        make_synthetic_criteo(data, 40, seed=2)
        batches = list(CriteoReader(16).stream([data]))
        keys = np.unique(np.concatenate([b.keys[:b.num_keys]
                                         for b in batches]))
        conf = TableConfig(embedx_dim=8, cvm_offset=3)
        snap = dict(keys=keys,
                    values=rng.uniform(size=(keys.size, 11)).astype('f4'),
                    state=np.zeros((keys.size, 2), 'f4'),
                    embedx_ok=rng.uniform(size=keys.size) < 0.5)
        out = save_inference_model({str(tmp_path / 'b')!r},
                                   DeepFM(26 * 11 + 13, (8,)), snap,
                                   criteo_feed_config(16), conf)
        pred = load_inference_model(out, device="cpu")
        s = np.concatenate([pred.predict_batch(b) for b in batches])
        assert s.shape == (40,) and np.isfinite(s).all()
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("SERVED", s.shape[0])
    """)
    assert res.returncode == 0, res.stderr
    assert "SERVED 40" in res.stdout


def test_trains_one_step_with_jax_blocked():
    """The training path (FusedTrainStep over a DeviceTable, the backward
    and push wrappers, the AUC) imports and runs one CPU step with jax and
    paddlebox_tpu blocked."""
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
        from paddlebox_tpu_torch.metrics import AucCalculator
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.ops.seqpool_kernel import (
            seqpool_cvm_grad_cuda)
        from paddlebox_tpu_torch.ops.sparse_push import sparse_push_cuda
        from paddlebox_tpu_torch.ps.device_table import DeviceTable
        from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
        B, S = 8, 3
        table = DeviceTable(TableConfig(embedx_dim=4), capacity=64,
                            device="cpu")
        fs = FusedTrainStep(DeepFM(S * 7, (8,)), table, TrainerConfig(),
                            B, S)
        params, opt = fs.init()
        auc = fs.init_auc_state()
        rng = np.random.default_rng(0)
        keys = np.zeros(1024, np.uint64)
        keys[:B * S] = rng.integers(1, 50, size=B * S)
        segs = np.full(1024, B * S, np.int32)
        segs[:B * S] = np.arange(B * S)
        labels = (rng.uniform(size=B) < 0.5).astype(np.float32)
        cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
        params, opt, auc, loss, preds = fs(
            params, opt, auc, keys, segs, cvm, labels,
            np.zeros((B, 0), np.float32), np.ones(B, np.float32))
        calc = AucCalculator()
        calc.absorb(auc)
        assert np.isfinite(float(loss)) and preds.shape == (B,)
        assert calc.compute()["ins_num"] == B and len(table) > 0
        assert seqpool_cvm_grad_cuda.launches == sparse_push_cuda.launches == 0
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("TRAINED", float(loss))
    """)
    assert res.returncode == 0, res.stderr
    assert "TRAINED" in res.stdout


def test_int8_arena_step_with_jax_blocked():
    """An int8 arena under bf16 dense compute trains one CPU step with jax
    and paddlebox_tpu blocked: show counts exact in the state, the push's
    plain version taken (no variant launched)."""
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import torch
        from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.ops.sparse_push import (PUSH_VARIANTS,
                                                         sparse_push_cuda)
        from paddlebox_tpu_torch.ps.device_table import DeviceTable
        from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
        B, S = 8, 3
        table = DeviceTable(TableConfig(embedx_dim=4, embedx_threshold=0.0),
                            capacity=64, device="cpu",
                            value_dtype=torch.int8)
        fs = FusedTrainStep(DeepFM(S * 7, (8,), dtype=torch.bfloat16),
                            table, TrainerConfig(bf16=True), B, S)
        params, opt = fs.init()
        auc = fs.init_auc_state()
        rng = np.random.default_rng(0)
        keys = np.zeros(1024, np.uint64)
        keys[:B * S] = rng.integers(1, 50, size=B * S)
        segs = np.full(1024, B * S, np.int32)
        segs[:B * S] = np.arange(B * S)
        labels = (rng.uniform(size=B) < 0.5).astype(np.float32)
        cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
        params, opt, auc, loss, preds = fs(
            params, opt, auc, keys, segs, cvm, labels,
            np.zeros((B, 0), np.float32), np.ones(B, np.float32))
        assert np.isfinite(float(loss)) and preds.shape == (B,)
        assert table.values.dtype == torch.int8
        assert float(table.state[:, 0].sum()) == B * S
        assert sparse_push_cuda.launches == 0
        assert all(c.launches == 0 for c in PUSH_VARIANTS.values())
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("INT8", float(loss))
    """)
    assert res.returncode == 0, res.stderr
    assert "INT8" in res.stdout


def test_device_prep_step_with_jax_blocked():
    """Device-prep training (the native index built from the port's own
    source, its mirror, the dedup and probe) runs one CPU step with jax and
    paddlebox_tpu blocked."""
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.ops import _build
        from paddlebox_tpu_torch.ops.device_index_kernel import (
            device_dedup_cuda, device_probe_cuda)
        from paddlebox_tpu_torch.ps import native
        from paddlebox_tpu_torch.ps.device_table import DeviceTable
        from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
        if not native.available():
            print("NO_NATIVE", native.build_error())
            sys.exit(0)
        assert _build.source("pbx_index").parent.parent.name == \\
            "paddlebox_tpu_torch"
        B, S = 8, 3
        table = DeviceTable(TableConfig(embedx_dim=4), capacity=64,
                            device="cpu", backend="native", index_threads=1)
        table.prepopulate(20)
        fs = FusedTrainStep(DeepFM(S * 7, (8,)), table, TrainerConfig(),
                            B, S, device_prep=True)
        params, opt = fs.init()
        auc = fs.init_auc_state()
        rng = np.random.default_rng(0)
        keys = np.zeros(256, np.uint64)
        keys[:B * S] = rng.integers(1, 50, size=B * S)
        segs = np.full(256, B * S, np.int32)
        segs[:B * S] = np.arange(B * S)
        labels = (rng.uniform(size=B) < 0.5).astype(np.float32)
        cvm = np.stack([np.ones(B, np.float32), labels], axis=1)
        params, opt, auc, loss, preds = fs.step_device(
            params, opt, auc, keys, segs, cvm, labels,
            np.zeros((B, 0), np.float32), np.ones(B, np.float32))
        assert np.isfinite(float(loss)) and preds.shape == (B,)
        assert len(table) == 20 + np.unique(keys[keys > 20]).size
        assert device_dedup_cuda.launches == device_probe_cuda.launches == 0
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("DEVICE_PREP", float(loss))
    """)
    assert res.returncode == 0, res.stderr
    assert "DEVICE_PREP" in res.stdout


def test_trainer_pass_with_jax_blocked(tmp_path):
    """A ``CTRTrainer`` pass over a MultiSlot file (the parser, the
    in-memory dataset, device prep when the native index builds, else
    host prep) and its evaluation run with jax and paddlebox_tpu
    blocked."""
    from conftest import make_slot_file
    from paddlebox_tpu.config import DataFeedConfig, SlotConfig
    conf = DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a"), SlotConfig("b"),
        SlotConfig("d", type="float", is_dense=True, dim=2)],
        batch_size=8, thread_num=2)
    data = make_slot_file(str(tmp_path / "part-0"), conf, 20, seed=4)
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig, TrainerConfig)
        from paddlebox_tpu_torch.data.dataset import SlotDataset
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.ps import native
        from paddlebox_tpu_torch.ps.device_table import DeviceTable
        from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b"),
            SlotConfig("d", type="float", is_dense=True, dim=2)],
            batch_size=8, thread_num=2)
        ds = SlotDataset(conf)
        ds.set_filelist([{data!r}])
        ds.load_into_memory()
        tconf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        table = DeviceTable(tconf, capacity=256, device="cpu",
                            index_threads=1)
        tr = CTRTrainer(DeepFM(2 * 7 + 2, (8,)), conf, tconf,
                        TrainerConfig(), table=table)
        assert tr.step.device_prep == native.available()
        losses = []
        m = tr.train_from_dataset(ds, lambda s, l, p: losses.append(l))
        ev = tr.evaluate(ds)
        assert m["ins_num"] == ev["ins_num"] == 20 and len(losses) == 3
        assert np.isfinite(losses).all() and len(table) > 0
        assert tr.timer.count["main"] == 3
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("TRAINER_PASS", m["auc"])
    """)
    assert res.returncode == 0, res.stderr
    assert "TRAINER_PASS" in res.stdout


def test_host_engine_with_jax_blocked(tmp_path):
    """The host-table engine (``CTRTrainer(use_device_table=False)``: pull,
    ``TrainStep``, push over a host ``EmbeddingTable``) runs a pass and its
    evaluation, and an MMoE ``TrainStep`` takes a step with [B, 2] labels
    under a ``MetricRegistry``, with jax and paddlebox_tpu blocked."""
    from conftest import make_slot_file
    from paddlebox_tpu.config import DataFeedConfig, SlotConfig
    conf = DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a"), SlotConfig("b"),
        SlotConfig("d", type="float", is_dense=True, dim=2)],
        batch_size=8, thread_num=2)
    data = make_slot_file(str(tmp_path / "part-0"), conf, 20, seed=5)
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig, TrainerConfig)
        from paddlebox_tpu_torch.data.dataset import SlotDataset
        from paddlebox_tpu_torch.metrics import MetricRegistry
        from paddlebox_tpu_torch.models import MMoE, WideDeep
        from paddlebox_tpu_torch.ps.table import EmbeddingTable
        from paddlebox_tpu_torch.trainer import TrainStep
        from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b"),
            SlotConfig("d", type="float", is_dense=True, dim=2)],
            batch_size=8, thread_num=2)
        ds = SlotDataset(conf)
        ds.set_filelist([{data!r}])
        ds.load_into_memory()
        tconf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        tr = CTRTrainer(WideDeep(2 * 7 + 2, (8,)), conf, tconf,
                        TrainerConfig(), use_device_table=False,
                        device="cpu")
        assert isinstance(tr.table, EmbeddingTable) and not tr.fused
        losses = []
        m = tr.train_from_dataset(ds, lambda s, l, p: losses.append(l))
        ev = tr.evaluate(ds)
        assert m["ins_num"] == ev["ins_num"] == 20 and len(losses) == 3
        assert np.isfinite(losses).all() and len(tr.table) > 0
        assert tr.timer.count["pull"] == tr.timer.count["push"] == 3
        B, S = 8, 2
        table = EmbeddingTable(tconf)
        step = TrainStep(MMoE(S * 7, 2, 3, (8,), 4, (4,)), tconf,
                         TrainerConfig(), B, S, device="cpu")
        params, opt = step.init()
        auc = step.init_auc_state()
        rng = np.random.default_rng(0)
        keys = np.zeros(64, np.uint64)
        keys[:B * S] = rng.integers(1, 50, size=B * S)
        segs = np.full(64, B * S, np.int32)
        segs[:B * S] = np.arange(B * S)
        labels = (rng.uniform(size=(B, 2)) < 0.5).astype(np.float32)
        cvm = np.stack([np.ones(B, np.float32), labels[:, 0]], axis=1)
        mask = np.ones(B, np.float32)
        emb = table.pull(keys)
        params, opt, auc, demb, loss, preds = step(
            params, opt, auc, emb, segs, cvm, labels,
            np.zeros((B, 0), np.float32), mask)
        table.push(keys, demb)
        reg = MetricRegistry()
        reg.init_metric("ctr_auc", num_buckets=1 << 10)
        reg["ctr_auc"].add(preds.numpy()[:, 0], labels[:, 0], mask=mask)
        assert preds.shape == (B, 2) and demb.shape == (64, 7)
        assert np.isfinite(float(loss))
        assert reg.get_metric_msg("ctr_auc")["ins_num"] == B
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("HOST_ENGINE", m["auc"])
    """)
    assert res.returncode == 0, res.stderr
    assert "HOST_ENGINE" in res.stdout


def test_train_from_files_with_jax_blocked(tmp_path):
    """``CTRTrainer.train_from_files`` (the tokenizer built from the port's
    own source, ``FastSlotReader``, ``train_stream``) runs a pass of 18
    batches, one full run of 16 on device prep, with jax and
    paddlebox_tpu blocked; so do ``MultiProcessReader``'s streams over
    the shared-memory fabric and the pipe (the single reader's batches,
    no segment left) and a ``workers=2`` pass (the same metrics), an
    ``ErrorBudget`` quarantining a bad line and an archive round
    trip."""
    from conftest import make_slot_file
    from paddlebox_tpu.config import DataFeedConfig, SlotConfig
    conf = DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a"), SlotConfig("b"),
        SlotConfig("d", type="float", is_dense=True, dim=2)],
        batch_size=4, thread_num=2)
    data = [make_slot_file(str(tmp_path / f"part-{i}"), conf, rows, seed=i)
            for i, rows in enumerate((40, 30))]
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig, TrainerConfig)
        from paddlebox_tpu_torch.data import fast_feed
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.ops import _build
        from paddlebox_tpu_torch.ps import native
        from paddlebox_tpu_torch.ps.device_table import DeviceTable
        from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b"),
            SlotConfig("d", type="float", is_dense=True, dim=2)],
            batch_size=4, thread_num=2)
        files = {data!r}
        assert _build.source("pbx_feed").parent.parent.name == \\
            "paddlebox_tpu_torch"
        assert sum(b.num_rows for b in
                   fast_feed.FastSlotReader(conf).batches(files)) == 70
        tconf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        table = DeviceTable(tconf, capacity=256, device="cpu",
                            index_threads=1)
        tr = CTRTrainer(DeepFM(2 * 7 + 2, (8,)), conf, tconf,
                        TrainerConfig(), table=table)
        assert tr.step.device_prep == native.available()
        m = tr.train_from_files(files)
        assert m["ins_num"] == 70 and tr._step_count == 18
        assert np.isfinite(m["auc"]) and len(table) > 0
        import os
        from paddlebox_tpu_torch.data import archive, ingest, shm_fabric
        from paddlebox_tpu_torch.data.parser import SlotParser
        want = list(fast_feed.FastSlotReader(conf).stream(files))
        for use_shm in (True, False):
            rd = fast_feed.MultiProcessReader(conf, workers=2,
                                              use_shm=use_shm)
            got = list(rd.stream(files))
            assert len(got) == len(want) == 17
            assert all(np.array_equal(x, y) for a, b in zip(got, want)
                       for x, y in zip(a, b))
            assert rd.shm_counters.get("leaked_segments", 0) == 0
        assert not [n for n in os.listdir("/dev/shm")
                    if n.startswith(shm_fabric.PREFIX + str(os.getpid()))]
        import copy
        model = DeepFM(2 * 7 + 2, (8,))
        trs = []
        for _ in range(2):
            t = DeviceTable(tconf, capacity=256, device="cpu",
                            index_threads=1)
            t.load_arena(table.values.numpy().copy(),
                         table.state.numpy().copy(), table.row_keys())
            trs.append(CTRTrainer(copy.deepcopy(model), conf, tconf,
                                  TrainerConfig(), table=t))
        assert trs[0].train_from_files(files, workers=2) == \
            trs[1].train_from_files(files)
        bad = {str(tmp_path / 'bad.txt')!r}
        with open(files[0]) as f, open(bad, "w") as g:
            g.write(f.read() + "1 1 x\\n")
        qdir = {str(tmp_path / 'quarantine')!r}
        budget = ingest.ErrorBudget(max_bad_lines=1, quarantine_dir=qdir)
        recs = SlotParser(conf).parse_file(bad, budget=budget)
        budget.close()
        assert len(recs) == 40 and len(budget.bad_lines) == 1
        assert len(os.listdir(qdir)) == 1
        blob = archive.records_to_bytes(recs)
        back = archive.records_from_bytes(blob)
        assert all(np.array_equal(a.uint64_feas, b.uint64_feas)
                   for a, b in zip(back, recs))
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("FILES_PASS", m["auc"])
    """)
    assert res.returncode == 0, res.stderr
    assert "FILES_PASS" in res.stdout


def test_staged_feed_and_obs_with_jax_blocked(tmp_path):
    """The staged device feed (``PBOX_FLAGS_feed_device_prefetch=2``), the
    trace and the heartbeat, with jax and paddlebox_tpu blocked: a staged
    ``train_from_files`` pass gives the unstaged pass's metrics, writes a
    ``pass`` heartbeat record with ``host_share`` and a Chrome trace with
    the feed's spans."""
    from conftest import make_slot_file
    from paddlebox_tpu.config import DataFeedConfig, SlotConfig
    conf = DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a"), SlotConfig("b")], batch_size=4, thread_num=2)
    data = [make_slot_file(str(tmp_path / f"part-{i}"), conf, rows, seed=i)
            for i, rows in enumerate((40, 30))]
    res = _run(f"""
        import json, os, sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import torch
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig, TrainerConfig)
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.obs import trace
        from paddlebox_tpu_torch.ps.device_table import DeviceTable
        from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b")], batch_size=4, thread_num=2)
        tconf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        out = []
        for staged in (False, True):
            if staged:
                os.environ.update(
                    PBOX_FLAGS_feed_device_prefetch="2",
                    PBOX_FLAGS_obs_trace_dir={str(tmp_path / 'tr')!r},
                    PBOX_FLAGS_obs_heartbeat_path={str(tmp_path / 'hb')!r})
            torch.manual_seed(0)
            table = DeviceTable(tconf, capacity=256, device="cpu",
                                index_threads=1)
            tr = CTRTrainer(DeepFM(2 * 7, (8,)), conf, tconf,
                            TrainerConfig(), table=table)
            out.append(tr.train_from_files({data!r}))
        assert out[0] == out[1] and out[1]["ins_num"] == 70
        assert tr._feed.ring.held == 0
        (rec,) = [json.loads(x) for x in open({str(tmp_path / 'hb')!r})]
        assert rec["hb"] == "pass" and 0 < rec["host_share"] <= 1
        names = {{e["name"] for e in json.load(open(trace.dump()))
                 ["traceEvents"]}}
        assert {{"feed.pack", "feed.h2d", "main"}} <= names, names
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("STAGED_PASS", out[1]["auc"])
    """)
    assert res.returncode == 0, res.stderr
    assert "STAGED_PASS" in res.stdout


def test_pass_loop_with_jax_blocked(tmp_path):
    """The day/pass loop (``PassManager`` over ``SparsePS``, its
    checkpoint writer, the donefile, ``resume``) runs a day of two passes
    with delta saves and a base with the dense state, and resumes into a
    fresh table and module, with jax and paddlebox_tpu blocked."""
    from conftest import make_slot_file
    from paddlebox_tpu.config import DataFeedConfig, SlotConfig
    conf = DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
    data = [make_slot_file(str(tmp_path / f"part-{i}"), conf, 20, seed=i)
            for i in range(2)]
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import torch
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig, TrainerConfig)
        from paddlebox_tpu_torch.data.dataset import SlotDataset
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.ps.device_table import DeviceTable
        from paddlebox_tpu_torch.ps.server import SparsePS
        from paddlebox_tpu_torch.trainer import donefile
        from paddlebox_tpu_torch.trainer.pass_manager import PassManager
        from paddlebox_tpu_torch.trainer.train_step import (
            make_dense_optimizer)
        from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
        tconf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        table = DeviceTable(tconf, capacity=256, device="cpu",
                            index_threads=1)
        tr = CTRTrainer(DeepFM(2 * 7, (8,)), conf, tconf, TrainerConfig(),
                        table=table)
        root = {str(tmp_path / "model")!r}
        pm = PassManager(SparsePS({{"embedding": table}}), root,
                         [SlotDataset(conf), SlotDataset(conf)])
        pm.set_date("20260101")
        ds = pm.begin_pass({data[:1]!r})
        pm.preload_next({data[1:]!r})
        tr.train_from_dataset(ds)
        pm.end_pass(save_delta=True)
        tr.train_from_dataset(pm.begin_pass([], preloaded=True))
        pm.end_pass(save_delta=True)
        pm.save_base(dense_state=(tr.params, tr.opt_state))
        pm.barrier()
        pm.close()
        assert [r["kind"] for r in donefile.read_done(root)] == \
            ["delta", "delta", "base"]
        fresh = DeviceTable(tconf, capacity=1, device="cpu")
        model = DeepFM(2 * 7, (8,))
        opt = make_dense_optimizer(TrainerConfig()).init(model)
        pm2 = PassManager(SparsePS({{"embedding": fresh}}), root,
                          [SlotDataset(conf)])
        assert pm2.resume(dense_template=(model, opt))[:2] == \
            ("20260101", 2)
        pm2.close()
        assert np.array_equal(np.sort(fresh.row_keys()),
                              np.sort(table.row_keys()))
        assert all(torch.equal(a, b) for a, b in zip(
            model.parameters(), tr.params.parameters()))
        assert int(opt["count"]) == int(tr.opt_state["count"]) == 6
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("PASS_LOOP", len(fresh))
    """)
    assert res.returncode == 0, res.stderr
    assert "PASS_LOOP" in res.stdout


def test_tiered_loop_with_jax_blocked(tmp_path):
    """A tiered table (a bounded arena over the host ``EmbeddingTable``,
    its optimizers and row helpers) under ``PassManager`` with the
    prefetched feed pass: two passes trained by ``CTRTrainer``, delta and
    base saves, a resume of the backing, with jax and paddlebox_tpu
    blocked."""
    from conftest import make_slot_file
    from paddlebox_tpu.config import DataFeedConfig, SlotConfig
    conf = DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
    data = [make_slot_file(str(tmp_path / f"part-{i}"), conf, 20, seed=i,
                           vocab=300) for i in range(2)]
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig, TrainerConfig)
        from paddlebox_tpu_torch.data.dataset import SlotDataset
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.ps.server import SparsePS
        from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
        from paddlebox_tpu_torch.trainer.pass_manager import PassManager
        from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
        tconf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        table = TieredDeviceTable(tconf, capacity=128, device="cpu",
                                  index_threads=1)
        tr = CTRTrainer(DeepFM(2 * 7, (8,)), conf, tconf, TrainerConfig(),
                        table=table)
        root = {str(tmp_path / "model")!r}
        pm = PassManager(SparsePS({{"embedding": table}}), root,
                         [SlotDataset(conf), SlotDataset(conf)])
        pm.set_date("20260101")
        ds = pm.begin_pass({data[:1]!r})
        pm.preload_next({data[1:]!r})
        pm.prefetch_feed_next()
        tr.train_from_dataset(ds)
        pm.end_pass(save_delta=True)
        tr.train_from_dataset(pm.begin_pass([], preloaded=True))
        pm.end_pass(save_delta=True)
        pm.save_base(dense_state=(tr.params, tr.opt_state))
        pm.barrier()
        pm.close()
        assert len(table) > table.capacity > 0
        fresh = TieredDeviceTable(tconf, capacity=16, device="cpu")
        pm2 = PassManager(SparsePS({{"embedding": fresh}}), root,
                          [SlotDataset(conf)])
        assert pm2.resume()[:2] == ("20260101", 2)
        pm2.close()
        a = table.backing.snapshot(reset_dirty=False)
        b = fresh.backing.snapshot(reset_dirty=False)
        oa, ob = np.argsort(a["keys"]), np.argsort(b["keys"])
        for k in ("keys", "values", "state", "embedx_ok"):
            assert np.array_equal(a[k][oa], b[k][ob]), k
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("TIERED_LOOP", len(fresh))
    """)
    assert res.returncode == 0, res.stderr
    assert "TIERED_LOOP" in res.stdout


def test_disk_ladder_and_ops_with_jax_blocked(tmp_path):
    """The disk ladder (``utils/faults.py``, ``ps/bloom.py``,
    ``ps/admission.py``, ``ps/ssd_tier.py`` under the tiered table with
    admission, the prefetch and the deferred demote), the dense lars,
    lamb and gradient merging, and ``ops/cvm.py`` with the seqpool
    variants, run with jax and paddlebox_tpu blocked."""
    res = _run(f"""
        import os, sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        os.environ["PBOX_FLAGS_ps_tier_demote"] = "1"
        import numpy as np
        import torch
        from paddlebox_tpu_torch.config import TableConfig, TrainerConfig
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.ops import (
            cvm, fused_seqpool_cvm_with_conv, fused_seqpool_cvm_with_pcoc)
        from paddlebox_tpu_torch.ps.admission import CountMinAdmission
        from paddlebox_tpu_torch.ps.bloom import BlockedBloom
        from paddlebox_tpu_torch.ps.ssd_tier import DiskTier
        from paddlebox_tpu_torch.ps.table import EmbeddingTable
        from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
        from paddlebox_tpu_torch.trainer.train_step import (
            make_dense_optimizer)
        from paddlebox_tpu_torch.utils.faults import (
            FaultInjector, install_injector)
        conf = TableConfig(embedx_dim=4, embedx_threshold=0.0,
                           show_clk_decay=0.5)
        backing = EmbeddingTable(conf)
        root = {str(tmp_path / "ssd")!r}
        disk = DiskTier(backing, root)
        t = TieredDeviceTable(conf, backing=backing, capacity=512,
                              disk=disk, device="cpu",
                              admit=CountMinAdmission(2.0, width=4096))
        keys = [np.concatenate([np.arange(1, 100, dtype=np.uint64)] * 2
                               + [np.arange(100 * p + 200, 100 * p + 260,
                                            dtype=np.uint64)])
                for p in range(3)]
        for p, k in enumerate(keys):
            w = t.begin_feed_pass(k)
            assert w >= 99, w
            t._dirty[1:w + 1] = True
            if p + 1 < len(keys):
                t.prefetch_feed_pass(keys[p + 1])
            t.end_pass()
            disk.evict_cold(show_threshold=np.inf)
            disk.compact()
        assert len(disk) >= 99 and len(t) == 0   # every row spilled
        again = DiskTier(EmbeddingTable(conf), root, resume=True)
        assert len(again) == len(disk)
        install_injector(FaultInjector(seed=1, fail_rate=1.0,
                                       ops=("ssd.read",)))
        try:
            again.read_rows(np.arange(1, 50, dtype=np.uint64))
            raise AssertionError("no injected fault")
        except OSError:
            pass
        install_injector(None)
        bloom = BlockedBloom(100)
        bloom.add_bulk(np.arange(1, 10, dtype=np.uint64))
        assert bloom.contains_bulk(np.arange(1, 10, dtype=np.uint64)).all()
        model = DeepFM(10, (4,))
        for kw in (dict(dense_optimizer="lars"), dict(dense_optimizer="lamb"),
                   dict(grad_merge_steps=2)):
            opt = make_dense_optimizer(TrainerConfig(**kw))
            st = opt.init(model)
            for p in model.parameters():
                p.grad = torch.ones_like(p)
            opt.update(model, st)
        x = torch.rand(4, 3, 6, requires_grad=True)
        cvm(x, torch.ones(4, 3, 2)).sum().backward()
        emb = torch.rand(10, 8, requires_grad=True)
        segs = torch.tensor([0, 0, 1, 2, 3, 4, 5, 5, 6, 6], dtype=torch.int32)
        fused_seqpool_cvm_with_conv(emb, segs, torch.ones(2, 3), 2,
                                    3).sum().backward()
        fused_seqpool_cvm_with_pcoc(emb, segs, torch.ones(2, 4),
                                    torch.ones(2, 1), 2, 3, 1).sum()
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("DISK_LADDER", len(disk))
    """)
    assert res.returncode == 0, res.stderr
    assert "DISK_LADDER" in res.stdout


def test_entry_points_default_to_cuda(tmp_path):
    from paddlebox_tpu_torch import resolve_device
    from paddlebox_tpu_torch.inference import CTRPredictor
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CTRPredictor(str(tmp_path))
    from paddlebox_tpu_torch.config import TableConfig
    from paddlebox_tpu_torch.metrics import new_auc_state
    from paddlebox_tpu_torch.ps.device_table import DeviceTable
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceTable(TableConfig())
    from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TieredDeviceTable(TableConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        new_auc_state()
    from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
    from paddlebox_tpu_torch.config import DataFeedConfig, TrainerConfig
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CTRTrainer(torch.nn.Linear(1, 1), DataFeedConfig(), TableConfig(),
                   TrainerConfig())
    # so does the file entry: its trainer builds its table on the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CTRTrainer(torch.nn.Linear(1, 1), DataFeedConfig(), TableConfig(),
                   TrainerConfig()).train_from_files(
            [str(tmp_path / "part-0")])
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_module_imports_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    res = _run(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import torch
        from paddlebox_tpu_torch.ops import (_build, device_index_kernel,
                                             seqpool_kernel, sparse_push)
        e = torch.ones(4, 11)
        s = torch.tensor([0, 0, 1, 2], dtype=torch.int32)
        out = seqpool_kernel.seqpool_cvm(e, s, 1, 2)
        assert out.shape == (1, 2, 11)
        grad = seqpool_kernel.seqpool_cvm_grad(out, s, torch.ones(1, 2), 1, 2)
        assert grad.shape == (4, 11)
        assert seqpool_kernel.seqpool_cvm_cuda.launches == 0
        assert seqpool_kernel.seqpool_cvm_grad_cuda.launches == 0
        assert sparse_push.sparse_push_cuda.launches == 0
        assert device_index_kernel.device_dedup_cuda.launches == 0
        for name in ("seqpool_cvm", "seqpool_cvm_grad", "sparse_push",
                     "device_index"):
            try:
                _build.load(name)
            except RuntimeError as e:
                assert "nvcc" in str(e), e
                print("NO_NVCC_OK", name)
    """, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("NO_NVCC_OK") == 4


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_deferred_tiered_low_precision_and_q8_serving_with_jax_blocked(
        tmp_path):
    """Deferred insert (the device miss ring and its polls) over a tiered
    int8 table, a bf16 tiered pass, and the int8 serving export (a
    ``.q8`` sibling of a base, a bundle's ``table.q8.npz`` served with the
    hot-key cache and coalescing) run with jax and paddlebox_tpu
    blocked."""
    res = _run(f"""
        import os, sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        os.environ["PBOX_FLAGS_serve_quantized"] = "1"
        os.environ["PBOX_FLAGS_serve_cache_rows"] = "64"
        os.environ["PBOX_FLAGS_serve_coalesce"] = "1"
        import numpy as np
        import torch
        from paddlebox_tpu_torch.ckpt import discovery
        from paddlebox_tpu_torch.config import (TableConfig, TrainerConfig,
                                                SlotConfig, DataFeedConfig)
        from paddlebox_tpu_torch.data.parser import SlotParser
        from paddlebox_tpu_torch.inference import (load_inference_model,
                                                   save_inference_model)
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.ps.quant_table import QuantServingTable
        from paddlebox_tpu_torch.ps.server import SparsePS
        from paddlebox_tpu_torch.ps.tiered_table import TieredDeviceTable
        from paddlebox_tpu_torch.trainer.fused_step import FusedTrainStep
        from paddlebox_tpu_torch.trainer.pass_manager import PassManager
        B, S, N = 8, 2, 64
        conf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        rng = np.random.default_rng(0)
        for dtype in (torch.int8, torch.bfloat16):
            t = TieredDeviceTable(conf, capacity=512, device="cpu",
                                  value_dtype=dtype, backend="native",
                                  index_threads=1)
            fs = FusedTrainStep(DeepFM(S * 7, (8,)), t, TrainerConfig(), B,
                                S, device_prep=True, insert_mode="deferred")
            st = [*fs.init(), fs.init_auc_state()]
            t.begin_feed_pass(np.arange(1, 40, dtype=np.uint64))
            for i in range(4):
                keys = np.zeros(N, np.uint64)
                keys[:40] = rng.integers(1, 120, 40)
                segs = np.full(N, B * S, np.int32)
                segs[:40] = np.sort(rng.integers(0, B * S, 40))
                lab = (rng.uniform(size=B) < 0.5).astype(np.float32)
                *st[:3], loss, _ = fs.step_device(
                    *st, keys, segs, np.stack([np.ones(B, 'f4'), lab], 1),
                    lab, np.zeros((B, 0), 'f4'), np.ones(B, 'f4'))
                assert np.isfinite(float(loss))
            assert int(t.miss_cnt[0]) > 0
            t.poll_misses()
            assert t._size > 40
            t.end_pass()
        class Null:
            def release_memory(self):
                pass
        pm = PassManager(SparsePS({{"embedding": t}}), {str(tmp_path / 'ck')!r},
                         [Null()])
        pm.pass_id = 1
        base = pm.save_base(wait=True)
        q8 = discovery.quantized_sibling(base)
        assert q8 is not None
        q = QuantServingTable(conf, device="cpu")
        q.load(os.path.join(q8, "embedding.npz"))
        assert len(q) == len(t) > 40
        pm.close()
        feed = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b")], batch_size=4)
        out = save_inference_model({str(tmp_path / 'b')!r},
                                   DeepFM(S * 7, (8,)),
                                   t.snapshot(), feed, conf)
        assert os.path.exists(os.path.join(out, "table.q8.npz"))
        pred = load_inference_model(out, device="cpu")
        recs = [SlotParser(feed).parse_line(f"1 0 2 {{i + 1}} 2 1 {{i + 3}}")
                for i in range(6)]
        s = pred.predict_records(recs)
        assert s.shape == (6,) and np.isfinite(s).all()
        assert pred.serves_quantized and pred.cache_stats()["rows"] > 0
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("DEFERRED_Q8_OK")
    """)
    assert res.returncode == 0, res.stderr
    assert "DEFERRED_Q8_OK" in res.stdout


def test_guard_profiler_postmortem_with_jax_blocked(tmp_path):
    """The train guard rolls a poisoned pass back to a committed base
    (``TrainGuard.run_pass`` over ``train_from_dataset``), a profiled pass
    prints its section table, and a postmortem bundle commits, with jax
    and paddlebox_tpu blocked."""
    from conftest import make_slot_file
    from paddlebox_tpu.config import DataFeedConfig, SlotConfig
    conf = DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
    data = make_slot_file(str(tmp_path / "part-0"), conf, 48, seed=0)
    res = _run(f"""
        import dataclasses, os, sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import torch
        from paddlebox_tpu_torch.ckpt import atomic
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig, TrainerConfig)
        from paddlebox_tpu_torch.data.dataset import SlotDataset
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.obs import postmortem
        from paddlebox_tpu_torch.obs.metrics import REGISTRY
        from paddlebox_tpu_torch.ps.device_table import DeviceTable
        from paddlebox_tpu_torch.ps.server import SparsePS
        from paddlebox_tpu_torch.trainer.guard import GuardPolicy, TrainGuard
        from paddlebox_tpu_torch.trainer.pass_manager import PassManager
        from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
        tconf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        table = DeviceTable(tconf, capacity=256, device="cpu",
                            index_threads=1)
        tr = CTRTrainer(DeepFM(2 * 7, (8,)), conf, tconf, TrainerConfig(),
                        table=table)
        pm = PassManager(SparsePS({{"embedding": table}}),
                         {str(tmp_path / "model")!r}, [SlotDataset(conf)])
        pm.set_date("20260101")
        ds = pm.begin_pass([{data!r}])
        tr.train_from_dataset(ds)
        pm.save_base(dense_state=(tr.params, tr.opt_state), wait=True)
        batches = list(ds.batches())
        batches[2] = dataclasses.replace(
            batches[2], labels=np.full_like(batches[2].labels, np.nan))

        class View:
            def batches(self):
                return iter(batches)

        g = TrainGuard(tr, pass_manager=pm, policy=GuardPolicy(
            on_nan="rollback", lag=1, quarantine_window=2)).attach()
        r0 = REGISTRY.counter("guard.rollbacks").get()
        out = g.run_pass(View())
        g.detach()
        assert REGISTRY.counter("guard.rollbacks").get() - r0 == 1
        assert all(torch.isfinite(p).all() for p in tr.params.parameters())
        assert np.isfinite(out["auc"])
        os.environ["PBOX_FLAGS_profile_trainer"] = "1"
        tr.train_from_dataset(ds)
        assert "step_total_ms" in tr.last_heartbeat["sections"]
        os.environ["PBOX_FLAGS_obs_postmortem_dir"] = \
            {str(tmp_path / "pm")!r}
        bundle = postmortem.maybe_dump("drill", exc=RuntimeError("x"))
        atomic.verify(bundle, require_manifest=True)
        assert len(os.listdir(bundle)) == 7
        pm.close()
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("GUARDED", REGISTRY.counter("guard.rollbacks").get())
    """)
    assert res.returncode == 0, res.stderr
    assert "GUARDED" in res.stdout


def test_serving_fleet_with_jax_blocked(tmp_path):
    """A process-scope ``ReplicaSet`` over a port bundle serves on the CPU
    with jax and paddlebox_tpu blocked in the parent (``sys.modules``) and
    in its spawned child (importable stand-ins that record the attempt and
    raise); behind a ``FrontDoor``, after a child is killed too. Without
    ``device`` the server and the fleets raise (no card here), the process
    child failing its spawn; batcher and transport load with torch and
    numpy blocked."""
    block = tmp_path / "blocked"
    marker = tmp_path / "imported.txt"
    for name in sorted(FORBIDDEN):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(
            f"open({str(marker)!r}, 'a').write({name!r} + '\\n')\n"
            f"raise ImportError('blocked: {name}')\n")
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(block)!r})
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig)
        from paddlebox_tpu_torch.inference.predictor import \\
            save_inference_model
        from paddlebox_tpu_torch.inference.server import (PredictServer,
                                                          predict_lines)
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.serving import FrontDoor, ReplicaSet
        from paddlebox_tpu_torch.serving.proc import SpawnError
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b")], batch_size=8)
        tconf = TableConfig(embedx_dim=4)
        keys = np.arange(1, 60, dtype=np.uint64)
        rng = np.random.default_rng(0)
        snap = dict(keys=keys, values=rng.uniform(size=(59, 7)).astype('f4'),
                    state=np.zeros((59, 2), 'f4'),
                    embedx_ok=rng.uniform(size=59) < 0.5)
        path = save_inference_model({str(tmp_path / 'b')!r},
                                    DeepFM(2 * 7, (8,)), snap, conf, tconf,
                                    version="20260101/00001")
        lines = [f"1 0 1 {{k}} 1 {{k + 1}}" for k in range(1, 11)]
        fleet = ReplicaSet.from_bundle(path, replicas=2, scope="process",
                                       device="cpu", probe_interval=60.0)
        with fleet, FrontDoor(fleet) as door:
            s = predict_lines(*door.address, lines, deadline_ms=60000.0)
            assert s.shape == (10,) and np.isfinite(s).all()
            fleet.replicas[0].kill()
            again = predict_lines(*door.address, lines, deadline_ms=60000.0)
            assert np.array_equal(again, s)
            assert fleet.versions()[1] == "20260101/00001"
        for make in (lambda: PredictServer(path),
                     lambda: ReplicaSet.from_bundle(path, replicas=1,
                                                    scope="thread")):
            try:
                make()
            except RuntimeError as e:
                assert "CUDA is not available" in str(e)
            else:
                raise AssertionError("served without a card")
        try:
            ReplicaSet.from_bundle(path, replicas=1, scope="process")
        except SpawnError as e:
            assert "before handshake" in str(e)
        else:
            raise AssertionError("a child served without a card")
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("FLEET", s.shape[0])
    """)
    assert res.returncode == 0, res.stderr
    assert "FLEET 10" in res.stdout
    assert not marker.exists(), marker.read_text()
    res = _run("""
        import sys
        sys.modules["torch"] = None
        sys.modules["numpy"] = None
        from paddlebox_tpu_torch.serving import batcher, transport
        import paddlebox_tpu_torch.serving as s
        assert s.DeadlineBatcher and s.TornFrame
        print("LIGHT")
    """)
    assert res.returncode == 0, res.stderr
    assert "LIGHT" in res.stdout


def test_host_tier_with_jax_blocked(tmp_path):
    """The host tier's modules and the embedded export import with jax and
    paddlebox_tpu blocked, the package names the host tier (no refusal),
    and a ``FileResolver`` over an endpoints file feeds an ``LBClient``
    that scores on a scripted line-protocol host after failing over from
    a dead endpoint."""
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import json, socket, threading
        import paddlebox_tpu_torch.serving as serving
        from paddlebox_tpu_torch.inference import export_embedded
        from paddlebox_tpu_torch.obs.fleet import FleetMetrics
        from paddlebox_tpu_torch.obs.metrics import MetricsRegistry
        from paddlebox_tpu_torch.serving import (FileResolver, HostFleet,
                                                 LBClient, ServingHost,
                                                 write_endpoints)
        assert serving.HostSpawnError and serving.HostUnavailable
        srv = socket.create_server(("127.0.0.1", 0))
        port = srv.getsockname()[1]

        def serve():
            conn, _ = srv.accept()
            f = conn.makefile("rwb")
            for raw in f:
                n = len(json.loads(raw)["lines"])
                f.write((json.dumps({{"scores": [0.25] * n}}) + "\\n")
                        .encode())
                f.flush()

        threading.Thread(target=serve, daemon=True).start()
        path = {str(tmp_path / "eps.json")!r}
        write_endpoints(path, ["127.0.0.1:1", f"127.0.0.1:{{port}}"], 3)
        reg = MetricsRegistry()
        lb = LBClient(FileResolver(path, registry=reg), registry=reg)
        assert lb.predict_lines(["a", "b"], deadline_ms=5000.0) == [0.25] * 2
        assert reg.counter("serving.failover_retries").get() == 1
        fm = FleetMetrics(interval=60.0).add_registry("lb", reg)
        assert fm.scrape_once() > 0
        lb.stop()
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("HOST TIER")
    """)
    assert res.returncode == 0, res.stderr
    assert "HOST TIER" in res.stdout


def test_ctr_ops_pv_and_auc_runner_with_jax_blocked(tmp_path):
    """The CTR dense ops (forward and rank_attention's gradient), a page-
    view batch and an ``AucRunner`` over a host-table trainer run with jax
    and paddlebox_tpu blocked."""
    from conftest import make_slot_file
    from paddlebox_tpu.config import DataFeedConfig, SlotConfig
    conf = DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
    data = make_slot_file(str(tmp_path / "part-0"), conf, 24, seed=5)
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import torch
        from paddlebox_tpu_torch import ops
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig, TrainerConfig)
        from paddlebox_tpu_torch.data.dataset import SlotDataset
        from paddlebox_tpu_torch.data.pv import PvBatchAssembler
        from paddlebox_tpu_torch.metrics.auc_runner import AucRunner
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
        ds = SlotDataset(conf)
        ds.set_filelist([{data!r}])
        ds.load_into_memory()
        for i, r in enumerate(ds.records):
            r.search_id, r.rank = i // 3, i % 3 + 1
        pb = next(PvBatchAssembler(conf, 2).batches(ds.records))
        assert pb.batch.rank_offset.shape == (8, 7) and pb.pv_num == 2
        x = torch.randn(8, 4)
        p = torch.randn(9 * 4, 5, requires_grad=True)
        ops.rank_attention(x, torch.from_numpy(pb.rank_offset), p,
                           3).sum().backward()
        assert p.grad.abs().sum() > 0
        assert ops.scaled_fc(x, torch.randn(4, 3), torch.zeros(3), 1.0,
                             1.0).dtype == torch.float32
        tconf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        tr = CTRTrainer(DeepFM(2 * 7, (8,)), conf, tconf, TrainerConfig(),
                        use_device_table=False, device="cpu")
        tr.train_from_dataset(ds)
        imp = AucRunner(tr).slot_importance(ds)
        pool = AucRunner(tr).slot_importance_pool(ds, pool_size=8)
        assert sorted(imp) == sorted(pool) == [0, 1]
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("CTR_OPS", imp)
    """)
    assert res.returncode == 0, res.stderr
    assert "CTR_OPS" in res.stdout


def test_ps_service_with_jax_blocked(tmp_path):
    """A 2-shard PS service spawns, a ``CTRTrainer`` trains a pass over its
    ``RemoteTable``, and a ``CTRPredictor`` scores through
    ``ps_endpoints``, with jax and paddlebox_tpu blocked; the shard
    children import no torch (their spawn takes well under the spawn
    timeout)."""
    from conftest import make_slot_file
    from paddlebox_tpu.config import DataFeedConfig, SlotConfig
    conf = DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
    data = make_slot_file(str(tmp_path / "part-0"), conf, 24, seed=6)
    res = _run(f"""
        import sys
        for name in {sorted(FORBIDDEN)!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        from paddlebox_tpu_torch.config import (DataFeedConfig, SlotConfig,
                                                TableConfig, TrainerConfig)
        from paddlebox_tpu_torch.data.dataset import SlotDataset
        from paddlebox_tpu_torch.inference.predictor import (
            CTRPredictor, save_inference_model)
        from paddlebox_tpu_torch.models import DeepFM
        from paddlebox_tpu_torch.obs.metrics import MetricsRegistry
        from paddlebox_tpu_torch.ps.service import RemoteTable, ShardService
        from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
        conf = DataFeedConfig(slots=[
            SlotConfig("label", type="float", is_dense=True, dim=1),
            SlotConfig("a"), SlotConfig("b")], batch_size=8, thread_num=2)
        ds = SlotDataset(conf)
        ds.set_filelist([{data!r}])
        ds.load_into_memory()
        tconf = TableConfig(embedx_dim=4, embedx_threshold=0.0)
        with ShardService({{"embedding": tconf}}, num_shards=2,
                          registry=MetricsRegistry()) as svc:
            remote = RemoteTable(tconf, svc.client(), cache_rows=0)
            tr = CTRTrainer(DeepFM(2 * 7, (8,)), conf, tconf,
                            TrainerConfig(), table=remote,
                            use_device_table=False, device="cpu")
            m = tr.train_from_dataset(ds)
            assert m["ins_num"] == 24 and len(remote) > 0
            bundle = save_inference_model({str(tmp_path / "b")!r}, tr.model,
                                          remote.merged_snapshot(), conf,
                                          tconf)
            pred = CTRPredictor(bundle, device="cpu",
                                ps_endpoints=svc.endpoints())
            local = CTRPredictor(bundle, device="cpu")
            assert np.array_equal(pred.predict_records(ds.records),
                                  local.predict_records(ds.records))
        assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r}
                       for k, v in sys.modules.items() if v is not None)
        print("PS_SERVICE", m["auc"])
    """)
    assert res.returncode == 0, res.stderr
    assert "PS_SERVICE" in res.stdout
