"""Serving bundles and the batch predictor (counterpart of
``paddlebox_tpu/inference/predictor.py``).

A bundle directory holds, in the reference's format:

    model.json    model class/kwargs, feed config, table config, use_cvm
    dense.npz     the flax leaf list of the dense params (``leaf_%05d``)
    table.npz     the embedding snapshot (keys, values, state, embedx_ok)

so a bundle written by either package loads in the other, for each model
class: ``DeepFM``, ``WideDeep``, ``FeedDNN``, ``MMoE``, and any class
given to ``register_model_class`` (``models/convert.py`` says what it must
have). ``CTRPredictor`` serves ragged slot batches on its device: the
table pull (``ps/serving_table.py``; unknown keys pull zeros), seqpool+CVM,
the model forward and the sigmoid all run there; a multi-task model
scores [n, T].

Not in the port yet (all off by default in the reference): the quantized
table (``table.q8.npz``), the hot-key cache, pull coalescing and a remote
PS (``ps_endpoints``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        TableConfig, TrainerConfig)
from paddlebox_tpu_torch.data.batch import BatchAssembler, CsrBatch
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.models.convert import (MODEL_CLASSES, build_model,
                                                flax_leaves_from_model,
                                                load_flax_leaves,
                                                model_config,
                                                register_model_class)
from paddlebox_tpu_torch.ps.serving_table import ServingTable
from paddlebox_tpu_torch.ps.table import state_dim
from paddlebox_tpu_torch.trainer.train_step import TrainStep
from paddlebox_tpu_torch.utils.checkpoint import (load_leaves, save_leaves,
                                                  write_npz)

__all__ = ["CTRPredictor", "load_inference_model", "register_model_class",
           "save_inference_model"]

SNAPSHOT_KEYS = ("keys", "values", "state", "embedx_ok")


def save_inference_model(path: str, model: nn.Module,
                         table: Dict[str, np.ndarray],
                         feed_conf: DataFeedConfig, table_conf: TableConfig,
                         use_cvm: bool = True,
                         version: Optional[str] = None) -> str:
    """Export a serving bundle of ``model`` (an instance of a class in
    ``MODEL_CLASSES``). ``table`` is a snapshot: ``keys`` [n] uint64,
    ``values`` [n, pull_dim] and ``state`` [n, state_dim] float32,
    ``embedx_ok`` [n] bool. The table file is written uncompressed: a
    multi-million-row snapshot of trained floats barely compresses."""
    if type(model).__name__ not in MODEL_CLASSES:
        raise ValueError(f"{type(model).__name__} is not a servable model "
                         "class (see register_model_class)")
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
            "model": model_config(model),
            "feed": json.loads(feed_conf.to_json()),
            "table": dataclasses.asdict(table_conf),
            "use_cvm": use_cvm,
            "version": version,
        }, f, indent=2)
    save_leaves(os.path.join(path, "dense.npz"),
                flax_leaves_from_model(model))
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
        table_path = os.path.join(path, "table.npz")
        if not os.path.exists(table_path) and \
                os.path.exists(os.path.join(path, "table.q8.npz")):
            raise NotImplementedError(
                "the bundle carries only a quantized table (table.q8.npz); "
                "the port serves the float32 table.npz")
        self.table = ServingTable(self.table_conf, self.device)
        self.table.load(table_path)
        self.num_slots = len(self.feed_conf.used_sparse_slots)
        self.dense_dim = sum(s.dim for s in self.feed_conf.used_dense_slots)
        # the per-slot width of the pooled features (the reference's
        # TrainStep.init shape)
        sparse_width = self.table_conf.pull_dim - (0 if meta["use_cvm"]
                                                   else 2)
        model = build_model(meta["model"]["class"], meta["model"]["kwargs"],
                            self.num_slots * sparse_width + self.dense_dim)
        # the fresh model's leaves are the template the file is checked
        # against before any weight is taken
        leaves = load_leaves(os.path.join(path, "dense.npz"),
                             flax_leaves_from_model(model))
        self.model = load_flax_leaves(model, leaves).to(self.device).eval()
        self._step = TrainStep(
            self.model, self.table_conf, TrainerConfig(),
            batch_size=self.feed_conf.batch_size, num_slots=self.num_slots,
            dense_dim=self.dense_dim, use_cvm=meta["use_cvm"],
            device=self.device)
        self.assembler = BatchAssembler(self.feed_conf, buckets)

    def _score_batch(self, batch: CsrBatch, emb: torch.Tensor) -> np.ndarray:
        """[num_rows] scores, or [num_rows, T] of a multi-task model."""
        cvm = torch.ones((batch.batch_size, 2), dtype=torch.float32,
                         device=self.device)
        preds = self._step.predict(self.model, emb, batch.segment_ids, cvm,
                                   batch.dense)
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
