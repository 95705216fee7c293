"""Criteo display-advertising format (counterpart of
``paddlebox_tpu/data/criteo.py``).

One instance per line, TAB-separated::

    label \\t I1 ... I13 \\t C1 ... C26

- integers -> one 13-wide dense float block, ``log1p`` transformed, with
  missing/negative -> 0;
- categoricals -> 26 sparse slots; key = (slot_index+1) << 32 | hex value,
  so keys are nonzero and never collide across slots; a missing field
  contributes no key.

``CriteoReader.stream`` yields ``CsrBatch`` directly. It fails fast on a
bad line, naming the file and line number (the reference's per-line error
budget is not ported yet).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                        SlotConfig, batch_bucket_spec)
from paddlebox_tpu_torch.data.batch import CsrBatch

N_DENSE = 13
N_CAT = 26


def criteo_feed_config(batch_size: int = 512) -> DataFeedConfig:
    """The DataFeedConfig of Criteo data: label + 13-wide dense + 26 sparse."""
    slots: List[SlotConfig] = [SlotConfig(name="label", type="float")]
    slots.append(SlotConfig(name="dense", type="float", is_dense=True,
                            dim=N_DENSE))
    slots += [SlotConfig(name=f"C{i + 1}") for i in range(N_CAT)]
    return DataFeedConfig(slots=slots, batch_size=batch_size)


def _parse_lines(lines: Sequence[bytes]):
    """Raw Criteo lines -> (labels, dense, keys, lengths)."""
    n = len(lines)
    labels = np.zeros(n, dtype=np.float32)
    dense = np.zeros((n, N_DENSE), dtype=np.float32)
    lengths = np.zeros((n, N_CAT), dtype=np.int32)
    keys: List[int] = []
    for r, line in enumerate(lines):
        parts = line.rstrip(b"\n").split(b"\t")
        if len(parts) != 1 + N_DENSE + N_CAT:
            raise ValueError(
                f"criteo row {r}: {len(parts)} fields, expected "
                f"{1 + N_DENSE + N_CAT}")
        labels[r] = float(parts[0] or b"0")
        for j in range(N_DENSE):
            f = parts[1 + j]
            if f:
                v = float(f)
                dense[r, j] = np.log1p(v) if v > 0 else 0.0
        for j in range(N_CAT):
            f = parts[1 + N_DENSE + j]
            if f:
                keys.append(((j + 1) << 32) | int(f, 16))
                lengths[r, j] = 1
    return labels, dense, np.array(keys, dtype=np.uint64), lengths


class CriteoReader:
    """Streams CsrBatches straight from Criteo-format text files."""

    def __init__(self, batch_size: int = 512,
                 buckets: Optional[BucketSpec] = None):
        self.batch_size = batch_size
        self.buckets = buckets or batch_bucket_spec(min_size=1024)

    def stream(self, files: Sequence[str]) -> Iterator[CsrBatch]:
        B = self.batch_size
        pending: List[bytes] = []
        where: List[Tuple[str, int]] = []
        for path in files:
            with open(path, "rb") as f:
                for lineno, line in enumerate(f, 1):
                    pending.append(line)
                    where.append((path, lineno))
                    if len(pending) == B:
                        yield self._assemble_checked(pending, where)
                        pending, where = [], []
        if pending:
            yield self._assemble_checked(pending, where)

    def _assemble_checked(self, lines: List[bytes],
                          where: List[Tuple[str, int]]) -> CsrBatch:
        try:
            return self._assemble(lines)
        except ValueError:
            # name the first bad line; the batch parse only knows its row
            for line, (path, lineno) in zip(lines, where):
                try:
                    _parse_lines([line])
                except ValueError as e:
                    raise ValueError(f"{path}:{lineno}: {e}") from e
            raise

    def _assemble(self, lines: List[bytes]) -> CsrBatch:
        B, S = self.batch_size, N_CAT
        labels, dense, keys, lengths = _parse_lines(lines)
        rows = labels.shape[0]
        nk = int(lengths.sum())
        npad = self.buckets.bucket(max(nk, 1))
        pk = np.zeros(npad, dtype=np.uint64)
        segs = np.full(npad, B * S, dtype=np.int32)
        pk[:nk] = keys
        # row-major segment ids: instance r, slot j -> r*S + j
        seg_src = (np.repeat(np.arange(rows) * S, S).reshape(rows, S)
                   + np.arange(S)[None, :])
        segs[:nk] = np.repeat(seg_src.reshape(-1), lengths.reshape(-1))
        pl = np.zeros(B, dtype=np.float32)
        pl[:rows] = labels
        pd = np.zeros((B, N_DENSE), dtype=np.float32)
        pd[:rows] = dense
        full_len = np.zeros((B, S), dtype=np.int32)
        full_len[:rows] = lengths
        return CsrBatch(keys=pk, segment_ids=segs, lengths=full_len,
                        labels=pl, dense=pd, batch_size=B, num_slots=S,
                        num_keys=nk, num_rows=rows)


def make_synthetic_criteo(path: str, rows: int, seed: int = 0,
                          vocab_per_slot: int = 1000) -> None:
    """Deterministic synthetic data in the Criteo format with planted
    signal: each categorical value carries a latent weight, each dense
    feature a latent coefficient; the label is Bernoulli of their sum.
    The same seed writes the same bytes as the reference package."""
    rng = np.random.default_rng(seed)
    cat_w = rng.normal(scale=0.8, size=(N_CAT, vocab_per_slot))
    dense_w = rng.normal(scale=0.25, size=N_DENSE)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for _ in range(rows):
            # zipf-ish categorical draws: hot head + tail, some missing
            cats = np.minimum(rng.zipf(1.3, size=N_CAT) - 1,
                              vocab_per_slot - 1)
            present = rng.uniform(size=N_CAT) > 0.05
            ints = rng.integers(0, 200, size=N_DENSE)
            int_present = rng.uniform(size=N_DENSE) > 0.1
            score = float(
                np.where(present, cat_w[np.arange(N_CAT), cats], 0.0).sum()
                + (np.log1p(ints) * dense_w * int_present).sum() * 0.3)
            label = int(rng.uniform() < 1.0 / (1.0 + np.exp(-score)))
            fields = [str(label)]
            fields += [str(int(v)) if p else ""
                       for v, p in zip(ints, int_present)]
            fields += [format(int(c), "08x") if p else ""
                       for c, p in zip(cats, present)]
            f.write("\t".join(fields) + "\n")
