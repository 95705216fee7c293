"""Serving bundles and the batch predictor (counterpart of
``paddlebox_tpu/inference/predictor.py``).

A bundle directory holds, in the reference's format:

    model.json    model class/kwargs, feed config, table config, use_cvm
    dense.npz     the flax leaf list of the dense params (``leaf_%05d``)
    table.npz     the embedding snapshot (keys, values, state, embedx_ok)
    table.q8.npz  under ``serve_quantized``: its int8 serving form
                  (``ps/quant_table.py``)

so a bundle written by either package loads in the other, for each model
class: ``DeepFM``, ``WideDeep``, ``FeedDNN``, ``MMoE``, and any class
given to ``register_model_class`` (``models/convert.py`` says what it must
have). ``CTRPredictor`` serves ragged slot batches on its device: the
table pull (``ps/serving_table.py``; unknown keys pull zeros), seqpool+CVM,
the model forward and the sigmoid all run there; a multi-task model
scores [n, T].

The serving knobs, read from their ``PBOX_FLAGS_*`` variables when a
predictor is built (``config.serving_econ_conf``), all off by default as in
the reference:

- ``serve_quantized``: serve the int8 table (``QuantServingTable``), from
  the bundle's ``table.q8.npz``, else quantized on load from ``table.npz``;
- ``serve_cache_rows``: a host ``HotKeyCache`` (``ps/replica_cache.py``) in
  front of the table pull, tied to the bundle's version; only its misses,
  deduplicated, reach the table;
- ``serve_coalesce``: ``predict_records`` pulls each distinct key of all
  its batches once and scores each batch from that pull.

Scores are the same bits with the cache and coalescing on or off.
``fwd_fingerprint`` and ``reload_of`` are the hot reload's ledger
(``serving/reload.py``).

``ps_endpoints`` (the shard-ordered ``host:port`` list of a PS service,
``ps/service/``) serves through the service instead of the bundle's
table: no table artifact is loaded, a ``RemoteTable`` (its own cache off,
the predictor's hot-key cache in front) pulls each batch's rows on the
host, and they reach the device in one host-to-device copy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch._device import DeviceLike, resolve_device
from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        TableConfig, TrainerConfig,
                                        serving_econ_conf)
from paddlebox_tpu_torch.data.batch import BatchAssembler, CsrBatch
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.models.convert import (MODEL_CLASSES, build_model,
                                                flax_leaves_from_model,
                                                flax_order, load_flax_leaves,
                                                model_config,
                                                register_model_class)
from paddlebox_tpu_torch.obs.metrics import REGISTRY
from paddlebox_tpu_torch.ps.quant_table import (QuantServingTable,
                                                quantize_snapshot)
from paddlebox_tpu_torch.ps.replica_cache import HotKeyCache
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
    multi-million-row snapshot of trained floats barely compresses. Under
    ``serve_quantized`` the bundle also gets ``table.q8.npz``; a layout
    the quantizer cannot take warns and leaves it out."""
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
    if serving_econ_conf().quantized:
        try:
            q8 = quantize_snapshot(snap, table_conf)
        except ValueError as e:
            warnings.warn(f"quantized bundle export skipped: {e}")
        else:
            write_npz(os.path.join(path, "table.q8.npz"), q8)
    return path


def load_inference_model(path: str,
                         device: DeviceLike = None) -> "CTRPredictor":
    return CTRPredictor(path, device=device)


class CTRPredictor:
    """Batch predictor over an exported bundle, on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``).
    ``coalesced_keys`` counts the pulls coalescing saved (the reference's
    ``serve.coalesced_keys`` counter).

    ``reload_of``, the predictor this one replaces in a hot reload: when
    their ``fwd_fingerprint``s differ, ``serving.reload_recompiled`` counts
    one (the reference's compile ledger; a same-shape swap counts none).
    ``load_table=False`` leaves the table empty for the caller to load (a
    reload's checkpoint rows replace the bundle's). ``ps_endpoints``
    serves the rows of the service's table ``ps_table`` instead of the
    bundle's (``serves_quantized`` is then false)."""

    def __init__(self, path: str, device: DeviceLike = None,
                 batch_size: Optional[int] = None,
                 buckets: Optional[BucketSpec] = None,
                 reload_of: Optional["CTRPredictor"] = None,
                 ps_endpoints: Optional[Sequence[str]] = None,
                 ps_table: str = "embedding", load_table: bool = True):
        self.device = resolve_device(device)
        with open(os.path.join(path, "model.json")) as f:
            meta = json.load(f)
        self.feed_conf = DataFeedConfig.from_dict(meta["feed"])
        if batch_size:
            self.feed_conf.batch_size = batch_size
        self.table_conf = TableConfig(**meta["table"])
        self.model_version = meta.get("version")
        self.use_cvm = bool(meta["use_cvm"])
        econ = serving_econ_conf()
        self.ps_endpoints = list(ps_endpoints) if ps_endpoints else None
        self.ps_table = ps_table
        self.serves_quantized = econ.quantized and not self.ps_endpoints
        if self.ps_endpoints:
            # the rows live on the service: no artifact to load or
            # quantize; one cache a replica (the predictor's, below), not
            # two stacked ones
            from paddlebox_tpu_torch.ps.service import (RemoteTable,
                                                        ServiceClient)
            self.table = RemoteTable(self.table_conf,
                                     ServiceClient(self.ps_endpoints),
                                     name=ps_table, cache_rows=0)
        elif econ.quantized:
            # the bundle's int8 artifact, else the float32 table quantized
            # on load (the same scheme and footprint)
            self.table = QuantServingTable(self.table_conf, self.device)
            qpath = os.path.join(path, "table.q8.npz")
            if load_table and os.path.exists(qpath):
                self.table.load(qpath)
            elif load_table:
                self.table.load_f32(os.path.join(path, "table.npz"))
        else:
            self.table = ServingTable(self.table_conf, self.device)
            if load_table:
                self.table.load(os.path.join(path, "table.npz"))
        self._cache = (HotKeyCache(econ.cache_rows, self.table_conf.pull_dim)
                       if econ.cache_rows else None)
        self._coalesce = econ.coalesce
        self.coalesced_keys = 0
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
        if reload_of is not None and \
                reload_of.fwd_fingerprint() != self.fwd_fingerprint():
            # the swap lands on a forward of another shape or class
            REGISTRY.add("serving.reload_recompiled")

    def fwd_fingerprint(self) -> tuple:
        """What would force another forward, where the reference keys its
        compiled forward: the model class and kwargs, ``use_cvm``, each
        flax leaf's shape and dtype in the leaf order, the batch geometry,
        ``pull_dim`` and the device. Equal fingerprints: a swap between
        the two predictors runs the same forward. Reads metadata only."""
        params = list(self.model.parameters())
        leaves = []
        for j, kernel in flax_order(self.model):
            js = j if isinstance(j, tuple) else (j,)
            shape = tuple(params[js[0]].shape)
            if isinstance(j, tuple):     # a stacked leaf: a tensor a stage
                shape = (len(j),) + shape
            leaves.append((shape[::-1] if kernel else shape,
                           str(params[js[0]].dtype)))
        cfg = model_config(self.model)
        return (cfg["class"], json.dumps(cfg["kwargs"], sort_keys=True),
                self.use_cvm, tuple(leaves), self.feed_conf.batch_size,
                self.num_slots, self.dense_dim, self.table_conf.pull_dim,
                str(self.device))

    # -- the pull: hot-key cache and coalescing -------------------------------

    def _pull_keys(self, keys: np.ndarray) -> torch.Tensor:
        """[N] keys -> [N, pull_dim] on the device, through the hot-key
        cache when it is on: hits come from the cache, the misses' unique
        keys from the table, whose rows the cache then takes. The same bits
        as a direct pull: the table is immutable for a ``model_version``,
        and the cache is cleared when the version changes."""
        cache = self._cache
        if cache is None:
            if self.ps_endpoints:
                return torch.from_numpy(self._host_rows(keys)).to(
                    self.device)
            return self.table.pull(keys, create=False)
        cache.set_version(self.model_version)
        vals, hit = cache.lookup(keys)
        if not hit.all():
            miss = ~hit
            # the padding key 0 is cached too: its row is zeros by the
            # padding contract, and a bucketed batch holds many of it
            uniq, inverse = np.unique(
                np.ascontiguousarray(keys[miss], dtype=np.uint64),
                return_inverse=True)
            uniq_vals = self._host_rows(uniq)
            cache.insert(uniq, uniq_vals)
            vals[miss] = uniq_vals[inverse]
        return torch.from_numpy(vals).to(self.device)

    def _host_rows(self, keys: np.ndarray) -> np.ndarray:
        """The table's rows of ``keys`` as host float32: the service's
        pull, or a device table's pull read back."""
        rows = self.table.pull(keys, create=False)
        return rows if self.ps_endpoints else rows.cpu().numpy()

    def cache_stats(self) -> Optional[Dict[str, int]]:
        """The hot-key cache's counters; None when it is off."""
        c = self._cache
        if c is None:
            return None
        return {"rows": c.size, "capacity": c.capacity, "hits": c.hits,
                "misses": c.misses, "evictions": c.evictions}

    def _score_batch(self, batch: CsrBatch, emb: torch.Tensor) -> np.ndarray:
        """[num_rows] scores, or [num_rows, T] of a multi-task model."""
        cvm = torch.ones((batch.batch_size, 2), dtype=torch.float32,
                         device=self.device)
        preds = self._step.predict(self.model, emb, batch.segment_ids, cvm,
                                   batch.dense)
        return preds.cpu().numpy()[:batch.num_rows]

    def predict_batch(self, batch: CsrBatch) -> np.ndarray:
        return self._score_batch(batch, self._pull_keys(batch.keys))

    def predict_records(self, records: Sequence[SlotRecord]) -> np.ndarray:
        B = self.feed_conf.batch_size
        if not records:
            return np.empty(0, np.float32)
        if self._coalesce:
            # one pull a distinct key over all the batches, fanned back out
            # by searchsorted (a pull is a function of the key)
            batches = [self.assembler.assemble(records[i:i + B])
                       for i in range(0, len(records), B)]
            all_keys = np.concatenate([b.keys for b in batches])
            uniq = np.unique(all_keys)
            self.coalesced_keys += int(all_keys.size - uniq.size)
            uvals = self._pull_keys(uniq)
            return np.concatenate([self._score_batch(
                b, uvals[torch.from_numpy(np.searchsorted(uniq, b.keys)).to(
                    self.device)]) for b in batches])
        # one assembled batch at a time: a large offline scoring call does
        # not hold every padded batch
        return np.concatenate([
            self.predict_batch(self.assembler.assemble(records[i:i + B]))
            for i in range(0, len(records), B)])
