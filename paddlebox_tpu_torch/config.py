"""Typed configuration objects (counterpart of ``paddlebox_tpu/config.py``).

The port's own copy of the dataclasses the serving path reads:
``SlotConfig``, ``DataFeedConfig``, ``TableConfig`` and ``BucketSpec``.
Field names and defaults match the reference, so a bundle's ``model.json``
written by either package loads in the other. The port has no flag
registry yet: ``batch_bucket_spec`` uses the reference flag default as a
constant.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

# default of the reference's ``batch_bucket_growth`` flag
BATCH_BUCKET_GROWTH = 1.3


@dataclasses.dataclass(frozen=True)
class SlotConfig:
    """One sparse or dense input slot."""

    name: str
    # "uint64" = sparse feature ids, "float" = dense values, "string" =
    # side-input keys mapped to table offsets at parse
    type: str = "uint64"
    is_dense: bool = False
    is_used: bool = True
    # for dense slots: fixed number of floats per instance
    dim: int = 1

    def __post_init__(self):
        if self.type not in ("uint64", "float", "string"):
            raise ValueError(f"slot {self.name}: bad type {self.type}")
        if self.type == "string" and self.is_dense:
            raise ValueError(
                f"slot {self.name}: string slots are sparse offset "
                "streams; is_dense is not supported")


@dataclasses.dataclass
class DataFeedConfig:
    """Slots, batch size and parse options of one data feed."""

    slots: List[SlotConfig] = dataclasses.field(default_factory=list)
    batch_size: int = 64
    # shell command each input file is piped through before parsing ("" = none)
    pipe_command: str = ""
    # parse an extra leading logkey column
    parse_logkey: bool = False
    # parse a leading "1 <ins_id>" group
    parse_ins_id: bool = False
    # name of the label slot (must be a float slot with dim 1)
    label_slot: str = "label"
    # subsample instances at parse time
    sample_rate: float = 1.0
    # number of parser threads
    thread_num: int = 4

    @property
    def used_sparse_slots(self) -> List[SlotConfig]:
        # string slots ride the sparse stream as uint64 table offsets
        return [s for s in self.slots if s.is_used and not s.is_dense
                and s.type in ("uint64", "string")]

    @property
    def used_dense_slots(self) -> List[SlotConfig]:
        return [s for s in self.slots if s.is_used and
                (s.is_dense or s.type == "float") and s.name != self.label_slot]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "DataFeedConfig":
        raw = dict(raw)
        raw["slots"] = [SlotConfig(**s) for s in raw.get("slots", [])]
        return DataFeedConfig(**raw)


@dataclasses.dataclass
class TableConfig:
    """Embedding table config. Pulled value layout:
    ``[show, clk, embed_w..., embedx(embedx_dim), expand(expand_dim)]``."""

    name: str = "embedding"
    # embedding vector dim excluding the [show, clk, embed_w] head
    embedx_dim: int = 8
    # number of leading CVM stat columns in the pulled value
    cvm_offset: int = 3
    # expand (second) embedding dim, 0 = disabled
    expand_dim: int = 0
    # per-row embedding-size routing (device arenas of the training path)
    variable_embedding: bool = False
    # sparse optimizer: "adagrad" | "sgd" | "adam"
    optimizer: str = "adagrad"
    learning_rate: float = 0.05
    initial_g2sum: float = 3.0
    initial_range: float = 1e-4
    # embedx vectors are only created once a feature's show count passes this
    embedx_threshold: float = 10.0
    # decay applied to show/clk at the end of each pass (1.0 = none)
    show_clk_decay: float = 0.98
    # drop features whose score < delete_threshold at shrink time
    delete_threshold: float = 0.25
    # number of table shards; keys routed by hash(key) % shards
    num_shards: int = 1
    seed: int = 0

    @property
    def pull_dim(self) -> int:
        """Width of one pulled value."""
        return self.cvm_offset + self.embedx_dim + self.expand_dim


@dataclasses.dataclass
class BucketSpec:
    """Geometric buckets for ragged key counts: a batch's key array is
    padded up to the nearest bucket so shapes repeat from batch to batch."""

    min_size: int = 1024
    max_size: int = 1 << 22
    growth: float = 1.3

    def bucket(self, n: int) -> int:
        size = self.min_size
        while size < n and size < self.max_size:
            # max() forces progress even when growth is ~1.0
            size = max(int(size * self.growth), size + 1)
            # round to a multiple of 256
            size = -(-size // 256) * 256
        if n > size:
            raise ValueError(f"key count {n} exceeds max bucket {self.max_size}")
        return size


def batch_bucket_spec(min_size: int = 1024,
                      max_size: int = 1 << 22) -> BucketSpec:
    """Default BucketSpec of the batch padding path (assembler, readers)."""
    return BucketSpec(min_size=min_size, max_size=max_size,
                      growth=BATCH_BUCKET_GROWTH)
