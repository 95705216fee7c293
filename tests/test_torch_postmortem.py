"""The port's crash flight recorder (``paddlebox_tpu_torch/obs/
postmortem.py``) held against the reference's (``paddlebox_tpu/obs/
postmortem.py``): the same failure leaves bundles with the same files and
keys; the manifest's crcs verify; one exception gives one bundle; a dump
does not reenter; ``install`` chains the excepthooks; and the fatal sites
of the trainer, the pass manager and the checkpoint writer dump."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.obs import postmortem as ref_postmortem
from paddlebox_tpu_torch.ckpt import atomic, faults
from paddlebox_tpu_torch.ckpt.writer import AsyncCheckpointWriter
from paddlebox_tpu_torch.config import (FLAG_DEFAULTS, DataFeedConfig,
                                        SlotConfig, TableConfig,
                                        TrainerConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.obs import postmortem
from paddlebox_tpu_torch.ps.device_table import DeviceTable
from paddlebox_tpu_torch.ps.server import SparsePS
from paddlebox_tpu_torch.trainer.pass_manager import PassManager
from paddlebox_tpu_torch.trainer.trainer import CTRTrainer

FILES = ["alerts.json", "crash.json", "flags.json", "heartbeat_tail.jsonl",
         "manifest.json", "metrics.json", "trace.json"]


@pytest.fixture
def armed(tmp_path, monkeypatch):
    """Both packages armed, each to its own dir; the heartbeat file (one
    for both) holds five lines."""
    hb = tmp_path / "hb.jsonl"
    hb.write_text("".join(json.dumps({"hb": "pass", "i": i}) + "\n"
                          for i in range(5)))
    dirs = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    ref_flags.set("obs_postmortem_dir", dirs["ref"])
    ref_flags.set("obs_heartbeat_path", str(hb))
    monkeypatch.setenv("PBOX_FLAGS_obs_postmortem_dir", dirs["port"])
    monkeypatch.setenv("PBOX_FLAGS_obs_heartbeat_path", str(hb))
    yield dirs
    ref_flags.set("obs_postmortem_dir", "")
    ref_flags.set("obs_heartbeat_path", "")


def load(bundle, name):
    with open(os.path.join(bundle, name)) as f:
        if name.endswith(".jsonl"):
            return f.read().splitlines()
        return json.load(f)


def failure():
    try:
        raise ValueError("the pass died")
    except ValueError as e:
        return e


def test_bundle_matches_reference(armed):
    exc = failure()
    ref = ref_postmortem.maybe_dump("trainer.train_from_dataset", exc=exc)
    port = postmortem.maybe_dump("trainer.train_from_dataset", exc=exc)
    assert ref and port and os.path.dirname(port) == armed["port"]
    assert os.path.basename(port).startswith("postmortem-")
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == FILES
    rc, pc = load(ref, "crash.json"), load(port, "crash.json")
    assert sorted(pc) == sorted(rc)
    assert sorted(pc["exception"]) == sorted(rc["exception"])
    for k in ("reason", "pid", "extra"):
        assert pc[k] == rc[k]
    assert pc["exception"]["type"] == "ValueError"
    assert pc["exception"]["message"] == "the pass died"
    assert "ValueError: the pass died" in pc["exception"]["traceback"]
    names = {t["name"] for t in pc["threads"]}
    assert threading.current_thread().name in names
    assert sorted(pc["threads"][0]) == sorted(rc["threads"][0])
    assert load(port, "alerts.json") == load(ref, "alerts.json") == []
    assert load(port, "heartbeat_tail.jsonl") == \
        load(ref, "heartbeat_tail.jsonl")
    assert len(load(port, "heartbeat_tail.jsonl")) == 5
    assert sorted(load(port, "trace.json")) == \
        sorted(load(ref, "trace.json"))
    assert isinstance(load(port, "metrics.json"), dict)
    # every flag the port reads, under the reference's name, with the
    # reference's value (the defaults here; the dirs were armed apart)
    pf, rf = load(port, "flags.json"), load(ref, "flags.json")
    assert sorted(pf) == sorted(FLAG_DEFAULTS) and set(pf) <= set(rf)
    assert pf.pop("obs_postmortem_dir") == armed["port"]
    assert {k: pf[k] for k in pf} == {k: rf[k] for k in pf}


def test_manifest_crcs_verify(armed):
    port = postmortem.dump_postmortem("drill", exc=failure())
    atomic.verify(port, require_manifest=True)
    with open(os.path.join(port, atomic.MANIFEST)) as f:
        listed = sorted(e["name"] for e in json.load(f)["files"])
    assert listed == [f for f in FILES if f != "manifest.json"]
    with open(os.path.join(port, "crash.json"), "r+b") as f:
        f.seek(2)
        f.write(b"#")
    with pytest.raises(atomic.IntegrityError, match="crash.json"):
        atomic.verify(port)


def test_dedupe_and_reentrancy(armed, monkeypatch):
    exc = failure()
    first = postmortem.maybe_dump("a", exc=exc)
    # the same exception again (its subsystem's site, then the
    # excepthook): the first bundle, no second one
    assert postmortem.maybe_dump("b", exc=exc) == first
    assert os.listdir(armed["port"]) == [os.path.basename(first)]
    # a dump while one is in flight returns at once, writing nothing
    monkeypatch.setattr(postmortem, "_in_dump", True)
    assert postmortem.dump_postmortem("c", exc=failure()) is None
    monkeypatch.setattr(postmortem, "_in_dump", False)
    assert postmortem.last_bundle() == first
    # not crashes, and an unarmed recorder: nothing
    assert postmortem.maybe_dump("d", exc=KeyboardInterrupt()) is None
    monkeypatch.delenv("PBOX_FLAGS_obs_postmortem_dir")
    assert postmortem.maybe_dump("e", exc=failure()) is None
    assert not postmortem.maybe_install()
    assert len(os.listdir(armed["port"])) == 1


def test_install_chains_excepthooks(armed, monkeypatch):
    seen = []
    monkeypatch.setattr(sys, "excepthook",
                        lambda *a: seen.append(("sys", a[1])))
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(("thread",
                                                  args.exc_value)))
    monkeypatch.setattr(postmortem, "_installed", False)
    assert postmortem.maybe_install()
    postmortem.install()                  # idempotent
    exc = failure()
    sys.excepthook(type(exc), exc, exc.__traceback__)
    t = threading.Thread(target=lambda: (_ for _ in ()).throw(
        RuntimeError("worker died")), name="doomed")
    t.start()
    t.join()
    assert [k for k, _ in seen] == ["sys", "thread"]
    reasons = sorted(load(os.path.join(armed["port"], b),
                          "crash.json")["reason"]
                     for b in os.listdir(armed["port"]))
    assert reasons == ["sys.excepthook", "thread doomed died"]


def _feed_conf():
    return DataFeedConfig(slots=[
        SlotConfig("label", type="float", is_dense=True, dim=1),
        SlotConfig("a")], batch_size=4)


class _Broken:
    def batches(self):
        raise RuntimeError("no batches today")


def test_fatal_sites_dump(armed, tmp_path):
    reasons = {}

    def last_reason():
        b = postmortem.last_bundle()
        return load(b, "crash.json")["reason"]

    table = DeviceTable(TableConfig(embedx_dim=4), capacity=64,
                        device="cpu", backend="numpy")
    tr = CTRTrainer(torch.nn.Linear(1, 1), _feed_conf(),
                    TableConfig(embedx_dim=4), TrainerConfig(), table=table)
    with pytest.raises(RuntimeError, match="no batches today"):
        tr.train_from_dataset(_Broken())
    reasons["trainer"] = last_reason()
    with pytest.raises(Exception):
        tr.train_from_files([str(tmp_path / "missing")])
    reasons["files"] = last_reason()
    pm = PassManager(SparsePS({"e": table}), str(tmp_path / "root"),
                     [SlotDataset(_feed_conf())])
    bad = tmp_path / "bad"
    bad.write_text("1 1 x\n")
    with pytest.raises(Exception, match="pass 1"):
        pm.begin_pass([str(bad)])
    reasons["begin_pass"] = last_reason()
    pm.close()
    w = AsyncCheckpointWriter()

    def crash():
        raise faults.InjectedCrash("delta.mid_write")
    w.submit("delta:20260101/00001", crash)
    with pytest.raises(faults.InjectedCrash):
        w.barrier()
    reasons["writer"] = last_reason()
    assert reasons == {
        "trainer": "trainer.train_from_dataset",
        "files": "trainer.train_from_files",
        "begin_pass": "pass_manager.begin_pass",
        "writer": "ckpt writer died in job 'delta:20260101/00001'"}
    assert len(os.listdir(armed["port"])) == 4
    assert np.all([atomic.is_committed(os.path.join(armed["port"], b),
                                       require_manifest=True)
                   for b in os.listdir(armed["port"])])


def test_flag_defaults_cover_the_port():
    """``flags.json`` lists every flag the port reads: each name an
    ``env_flag``/``flag`` call in the package reads is in
    ``FLAG_DEFAULTS``, with the reference's default."""
    import ast
    import re
    port = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "paddlebox_tpu_torch")
    read = set()
    for dirpath, _, files in os.walk(port):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                src = fh.read()
            for node in ast.walk(ast.parse(src)):
                if isinstance(node, ast.Call) and getattr(
                        node.func, "id", getattr(node.func, "attr", "")) \
                        in ("env_flag", "flag") and node.args and \
                        isinstance(node.args[0], ast.Constant):
                    read.add(node.args[0].value)
            read |= set(re.findall(r"PBOX_FLAGS_([a-z][a-z0-9_]*)", src))
    assert read and read <= set(FLAG_DEFAULTS), read - set(FLAG_DEFAULTS)
    ref_defaults = {k: f.default for k, f in ref_flags._REGISTRY.items()}
    assert {k: ref_defaults[k] for k in FLAG_DEFAULTS} == FLAG_DEFAULTS
