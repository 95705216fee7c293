"""The port stands alone: no jax, flax, optax or paddlebox_tpu import, in
the package, in chip_smoke.py or in kernel_versions.py; it serves and
trains with them blocked;
its entry points default to the card and raise without one; its kernel
modules import without a CUDA toolkit."""

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
                                           "kernel_versions.py")]
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        new_auc_state()
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
