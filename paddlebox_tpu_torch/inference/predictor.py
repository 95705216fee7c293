"""Serving bundles and the batch predictor (counterpart of
``paddlebox_tpu/inference/predictor.py``).

A bundle directory holds, in the reference's format:

    model.json    model class/kwargs, feed config, table config, use_cvm
    dense.npz     the flax leaf list of the dense params (``leaf_%05d``)
    table.npz     the embedding snapshot (keys, values, state, embedx_ok)

so a bundle written by either package loads in the other. ``CTRPredictor``
serves ragged slot batches on its device: the table pull (unknown keys pull
zeros), seqpool+CVM, the model forward and the sigmoid all run there.

Not in the port yet (all off by default in the reference): the quantized
table (``table.q8.npz``), the hot-key cache, pull coalescing and a remote
PS (``ps_endpoints``). Models other than DeepFM come later too.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.config import BucketSpec, DataFeedConfig, TableConfig
from paddlebox_tpu_torch.data.batch import BatchAssembler, CsrBatch
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.models.convert import (deepfm_from_flax_leaves,
                                                flax_leaves_from_deepfm)
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ps.table import EmbeddingTable, state_dim
from paddlebox_tpu_torch.trainer.train_step import TrainStep
from paddlebox_tpu_torch.utils.checkpoint import (load_leaves, save_leaves,
                                                  write_npz)

SNAPSHOT_KEYS = ("keys", "values", "state", "embedx_ok")


def _model_config(model: DeepFM) -> Dict:
    if not isinstance(model, DeepFM):
        raise NotImplementedError(
            f"the port serves DeepFM only, got {type(model).__name__}")
    return {"class": "DeepFM",
            "kwargs": {"num_tasks": model.num_tasks,
                       "hidden": list(model.hidden),
                       "cvm_offset": model.cvm_offset}}


def save_inference_model(path: str, model: DeepFM,
                         table: Dict[str, np.ndarray],
                         feed_conf: DataFeedConfig, table_conf: TableConfig,
                         use_cvm: bool = True,
                         version: Optional[str] = None) -> str:
    """Export a serving bundle. ``table`` is a snapshot: ``keys`` [n] uint64,
    ``values`` [n, pull_dim] and ``state`` [n, state_dim] float32,
    ``embedx_ok`` [n] bool. The table file is written uncompressed: a
    multi-million-row snapshot of trained floats barely compresses."""
    snap = {k: np.asarray(table[k]) for k in SNAPSHOT_KEYS}
    n = snap["keys"].size
    want = {"keys": ((n,), np.uint64),
            "values": ((n, table_conf.pull_dim), np.float32),
            "state": ((n, state_dim(table_conf)), np.float32),
            "embedx_ok": ((n,), np.bool_)}
    for k, (shape, dtype) in want.items():
        if snap[k].shape != shape or snap[k].dtype != dtype:
            raise ValueError(f"table snapshot {k!r} is {snap[k].dtype} "
                             f"{snap[k].shape}, expected "
                             f"{np.dtype(dtype)} {shape}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({
            "model": _model_config(model),
            "feed": json.loads(feed_conf.to_json()),
            "table": dataclasses.asdict(table_conf),
            "use_cvm": use_cvm,
            "version": version,
        }, f, indent=2)
    save_leaves(os.path.join(path, "dense.npz"), flax_leaves_from_deepfm(model))
    write_npz(os.path.join(path, "table.npz"), snap, compressed=False)
    return path


def load_inference_model(path: str,
                         device: DeviceLike = None) -> "CTRPredictor":
    return CTRPredictor(path, device=device)


class CTRPredictor:
    """Batch predictor over an exported bundle, on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``)."""

    def __init__(self, path: str, device: DeviceLike = None,
                 batch_size: Optional[int] = None,
                 buckets: Optional[BucketSpec] = None):
        self.device = resolve_device(device)
        with open(os.path.join(path, "model.json")) as f:
            meta = json.load(f)
        self.feed_conf = DataFeedConfig.from_dict(meta["feed"])
        if batch_size:
            self.feed_conf.batch_size = batch_size
        self.table_conf = TableConfig(**meta["table"])
        self.model_version = meta.get("version")
        cls = meta["model"]["class"]
        if cls != "DeepFM":
            raise NotImplementedError(f"the port serves DeepFM only; the "
                                      f"bundle holds {cls}")
        kwargs = meta["model"]["kwargs"]
        table_path = os.path.join(path, "table.npz")
        if not os.path.exists(table_path) and \
                os.path.exists(os.path.join(path, "table.q8.npz")):
            raise NotImplementedError(
                "the bundle carries only a quantized table (table.q8.npz); "
                "the port serves the float32 table.npz")
        self.table = EmbeddingTable(self.table_conf, self.device)
        self.table.load(table_path)
        self.num_slots = len(self.feed_conf.used_sparse_slots)
        self.dense_dim = sum(s.dim for s in self.feed_conf.used_dense_slots)
        self._step = TrainStep(
            self.table_conf, batch_size=self.feed_conf.batch_size,
            num_slots=self.num_slots, dense_dim=self.dense_dim,
            use_cvm=meta["use_cvm"])
        hidden = tuple(kwargs["hidden"])
        cvm_offset = kwargs.get("cvm_offset", 3)
        in_dim = self.num_slots * self._step.sparse_width + self.dense_dim
        template = flax_leaves_from_deepfm(DeepFM(in_dim, hidden, cvm_offset))
        leaves = load_leaves(os.path.join(path, "dense.npz"), template)
        self.model = deepfm_from_flax_leaves(
            leaves, hidden, cvm_offset).to(self.device).eval()
        self.assembler = BatchAssembler(self.feed_conf, buckets)

    def _score_batch(self, batch: CsrBatch, emb: torch.Tensor) -> np.ndarray:
        dev = self.device
        cvm = torch.ones((batch.batch_size, 2), dtype=torch.float32,
                         device=dev)
        segs = torch.from_numpy(batch.segment_ids).to(dev)
        dense = torch.from_numpy(batch.dense).to(dev)
        preds = self._step.predict(self.model, emb, segs, cvm, dense)
        return preds.cpu().numpy()[:batch.num_rows]

    def predict_batch(self, batch: CsrBatch) -> np.ndarray:
        return self._score_batch(batch,
                                 self.table.pull(batch.keys, create=False))

    def predict_records(self, records: Sequence[SlotRecord]) -> np.ndarray:
        B = self.feed_conf.batch_size
        if not records:
            return np.empty(0, np.float32)
        return np.concatenate([
            self.predict_batch(self.assembler.assemble(records[i:i + B]))
            for i in range(0, len(records), B)])
