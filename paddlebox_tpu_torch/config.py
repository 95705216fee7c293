"""Typed configuration objects (counterpart of ``paddlebox_tpu/config.py``).

The port's own copy of the dataclasses the serving and training paths
read: ``SlotConfig``, ``DataFeedConfig``, ``TableConfig``,
``TrainerConfig`` and ``BucketSpec``, the serving knobs'
``ServingEconConfig``, the shared-memory ingest fabric's
``ingest_shm_conf`` and the staged device feed's ``feed_prefetch_conf``.
Field names and defaults match the reference, so a bundle's ``model.json``
written by either package loads in the other. The port has no flag
registry: ``batch_bucket_spec`` uses the reference flag default as a
constant, ``env_flag`` reads a reference flag's environment variable at
each call, ``FLAG_DEFAULTS`` names every flag the port reads with the
reference's default (``all_flags`` gives their values, the postmortem
bundle's ``flags.json``), and ``resolve_day`` applies ``fix_dayid``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

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
class TrainerConfig:
    """Dense-side training settings (the reference's ``TrainerConfig``).
    ``dense_sync_steps``, ``metrics``, ``num_devices`` and ``profile`` are
    the trainer loop's (``trainer/trainer.py::CTRTrainer``): on one device
    it ignores ``dense_sync_steps`` and ``metrics`` as the reference does,
    refuses ``num_devices`` > 1 without a mesh and prints the profile
    line; over a mesh ``dense_sync_steps`` > 0 trains LocalSGD on the
    host table (``parallel/dp_step.py`` ``ShardedTrainStep``: the
    replicas' params averaged every ``dense_sync_steps`` steps), as the
    reference does."""

    # dense optimizer, in optax's math: "adam" | "adamw" | "sgd" |
    # "adagrad" | "lars" | "lamb" (trainer/train_step.py)
    dense_optimizer: str = "adam"
    dense_learning_rate: float = 1e-3
    # weight decay for lars/lamb/adamw (others ignore it)
    dense_weight_decay: float = 0.0
    # sync dense params every k steps (0 = every step)
    dense_sync_steps: int = 0
    # use bf16 for dense compute
    bf16: bool = False
    # accumulate k micro-batches before one optimizer update; 0/1 = off
    grad_merge_steps: int = 0
    # rematerialize the dense tower on backward
    recompute: bool = False
    # names of metric phases to compute
    metrics: List[str] = dataclasses.field(default_factory=lambda: ["auc"])
    # number of data-parallel devices (0 = all visible)
    num_devices: int = 0
    # profiler on/off
    profile: bool = False


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


def env_flag(flag: str, default: Any) -> Any:
    """The reference's flag ``flag`` as its environment variable
    ``PBOX_FLAGS_<flag>`` sets it, read at each call, else ``default``
    (also for an empty value of a flag that is not a string); parsed by
    the default's type as the reference parses it (a bool is on for 1,
    true, yes or on)."""
    raw = os.environ.get("PBOX_FLAGS_" + flag)
    if raw is None or (not raw.strip() and not isinstance(default, str)):
        return default
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return type(default)(raw)


#: Every reference flag the port reads through ``env_flag``, with the
#: reference's default (``paddlebox_tpu/flags.py``). A test holds it to
#: the package's ``env_flag`` calls.
FLAG_DEFAULTS: Dict[str, Any] = {
    "enable_pullpush_dedup_keys": True,
    "record_pool_max_size": 2_000_000,
    "dataset_shuffle_thread_num": 4,
    "dataset_merge_thread_num": 4,
    "slotpool_auto_clear": False,
    "enable_pull_padding_zero": True,
    "check_nan_inf": False,
    "embedding_backend": "auto",
    "fix_dayid": 0,
    "profile_trainer": False,
    "ingest_max_bad_lines": 0,
    "ingest_max_bad_frac": 0.0,
    "ingest_max_bad_files": 0,
    "ingest_retries": 3,
    "ingest_stall_timeout": 300.0,
    "ingest_shm": True,
    "ingest_shm_blocks": 4,
    "ingest_shm_block_bytes": 16 << 20,
    "ingest_shm_crc": True,
    "ingest_shm_defer_recycle": False,
    "ingest_quarantine_dir": "",
    "obs_trace_dir": "",
    "obs_trace_ring": 65536,
    "obs_heartbeat_path": "",
    "obs_heartbeat_max_bytes": 0,
    "obs_heartbeat_keep": 3,
    "obs_postmortem_dir": "",
    "obs_postmortem_hb_tail": 200,
    "obs_role": "",
    "feed_device_prefetch": 0,
    "feed_staging_buffers": 0,
    "guard_sentinel_lag": 8,
    "guard_max_rollbacks": 2,
    "guard_step_retries": 3,
    "guard_quarantine_window": 16,
    "guard_on_nan": "rollback",
    "guard_on_loss_spike": "skip",
    "guard_on_auc_collapse": "rollback",
    "guard_on_emb_blowup": "skip",
    "guard_loss_z": 6.0,
    "guard_loss_warmup": 32,
    "guard_auc_window": 5,
    "guard_auc_drop": 0.05,
    "guard_nonfinite_rows": 0,
    "ps_bloom_bits_per_key": 10,
    "ps_admit_shows": 0.0,
    "ps_admit_decay": 1.0,
    "ps_admit_width": 1 << 18,
    "ps_tier_demote": False,
    "ps_service_shards": 2,
    "ps_service_deadline": 5.0,
    "ps_service_retries": 3,
    "ps_service_cache_rows": 0,
    "ps_service_spawn_timeout": 60.0,
    "serve_quantized": False,
    "serve_cache_rows": 0,
    "serve_coalesce": False,
    "obs_slo_interval": 1.0,
    "obs_exemplar_ms": 0.0,
    "serve_replicas": 2,
    "serve_deadline_ms": 200.0,
    "serve_batch_margin_ms": 5.0,
    "serve_batch_wait_ms": 2.0,
    "serve_probe_interval": 0.25,
    "serve_drain_timeout": 5.0,
    "serve_max_pending": 64,
    "serve_reload_poll": 1.0,
    "serve_replica_scope": "thread",
    "serve_retry_budget": 3,
    "serve_restart_budget": 3,
    "serve_restart_window": 30.0,
    "serve_restart_backoff": 0.5,
    "serve_circuit_reset": 0.0,
    "serve_request_timeout": 30.0,
    "serve_spawn_timeout": 60.0,
    "serve_heartbeat_timeout": 10.0,
    "serve_hosts": 2,
    "serve_resolver_poll": 0.5,
    "serve_lb_probe_interval": 0.5,
    "serve_lb_eject_reset": 2.0,
    "obs_fleet_interval": 1.0,
}


def flag(name: str) -> Any:
    """``env_flag(name, FLAG_DEFAULTS[name])``: a flag the port reads,
    with the reference's default."""
    return env_flag(name, FLAG_DEFAULTS[name])


def all_flags() -> Dict[str, Any]:
    """Every flag the port reads with its value now (the counterpart of
    the reference's ``flags.all_flags``)."""
    return {name: flag(name) for name in FLAG_DEFAULTS}


def resolve_day(day: Any) -> str:
    """The day id with the ``fix_dayid`` replay override applied
    (``PBOX_FLAGS_fix_dayid`` nonzero pins it): the one resolution that
    ``PassManager.set_date`` and ``compat.BoxPSDataset.set_date`` share,
    as in the reference."""
    fixed = int(flag("fix_dayid"))
    return str(fixed) if fixed else str(day)


def feed_prefetch_conf() -> Tuple[int, int]:
    """Validated (depth, buffers) of the staged device feed, from the
    ``feed_device_prefetch`` and ``feed_staging_buffers`` flags (their
    ``PBOX_FLAGS_*`` variables, read at each call), as the reference
    resolves them: buffers 0 means depth + 3 (depth staged, one packing,
    the consumer's two-run dispatch window); a negative depth, or buffers
    below depth + 1 at a depth > 0, raises ``ValueError``."""
    depth = int(env_flag("feed_device_prefetch", 0))
    if depth < 0:
        raise ValueError(
            f"feed_device_prefetch must be >= 0, got {depth}")
    buffers = int(env_flag("feed_staging_buffers", 0))
    if buffers == 0:
        buffers = depth + 3
    if depth > 0 and buffers < depth + 1:
        raise ValueError(
            f"feed_staging_buffers ({buffers}) must be >= "
            f"feed_device_prefetch + 1 ({depth + 1}): one ring row packs "
            "while `depth` are staged — fewer deadlocks the producer")
    return depth, buffers


def ingest_shm_conf(enabled: Optional[bool] = None
                    ) -> Tuple[bool, int, int, bool, bool]:
    """Validated (enabled, blocks, block_bytes, crc, defer_recycle) of
    the shared-memory ingest fabric, from the ``ingest_shm``,
    ``ingest_shm_blocks``, ``ingest_shm_block_bytes``, ``ingest_shm_crc``
    and ``ingest_shm_defer_recycle`` flags (their ``PBOX_FLAGS_*``
    variables, read at each call), validated as the reference validates
    them. ``enabled`` overrides the ``ingest_shm`` flag
    (``MultiProcessReader``'s ``use_shm``), and only an enabled fabric's
    knobs are checked."""
    if enabled is None:
        enabled = bool(env_flag("ingest_shm", True))
    else:
        enabled = bool(enabled)
    blocks = int(env_flag("ingest_shm_blocks", 4))
    block_bytes = int(env_flag("ingest_shm_block_bytes", 16 << 20))
    crc = bool(env_flag("ingest_shm_crc", True))
    defer = bool(env_flag("ingest_shm_defer_recycle", False))
    if enabled and blocks < 2:
        raise ValueError(
            f"ingest_shm_blocks ({blocks}) must be >= 2: one block maps "
            "parent-side while another parses — fewer serializes the "
            "fabric into lockstep (or deadlocks it under defer-recycle)")
    if enabled and block_bytes < (1 << 16):
        raise ValueError(
            f"ingest_shm_block_bytes ({block_bytes}) must be >= 64KiB: "
            "sub-page blocks shred every parsed file into thousands of "
            "descriptors and the pipe chatter dominates again")
    return enabled, blocks, block_bytes, crc, defer


@dataclasses.dataclass(frozen=True)
class ServingEconConfig:
    """Validated serving-economics knobs."""

    quantized: bool
    cache_rows: int
    coalesce: bool


def serving_econ_conf() -> ServingEconConfig:
    """The ``serve_quantized``, ``serve_cache_rows`` and ``serve_coalesce``
    flags (their ``PBOX_FLAGS_*`` variables, read at each call), validated
    as the reference validates them: a negative cache, or one under 16
    rows, fails; the cache needs ``enable_pull_padding_zero`` and
    coalescing ``enable_pullpush_dedup_keys`` (both on by default)."""
    quantized = bool(env_flag("serve_quantized", False))
    cache_rows = int(env_flag("serve_cache_rows", 0))
    coalesce = bool(env_flag("serve_coalesce", False))
    if cache_rows < 0:
        raise ValueError(
            f"serve_cache_rows must be >= 0, got {cache_rows}")
    if 0 < cache_rows < 16:
        raise ValueError(
            f"serve_cache_rows ({cache_rows}) is smaller than one "
            "batch's working set; a sub-16-row cache evicts its own "
            "entries every lookup (0 disables the cache)")
    if cache_rows and not env_flag("enable_pull_padding_zero", True):
        # the cache keys rows by feasign and relies on the padding
        # contract (key 0 pulls zeros, never owns a row)
        raise ValueError(
            "serve_cache_rows requires enable_pull_padding_zero (the "
            "cache treats feasign 0 as the padding row)")
    if coalesce and not env_flag("enable_pullpush_dedup_keys", True):
        raise ValueError(
            "serve_coalesce depends on key dedup "
            "(enable_pullpush_dedup_keys): coalescing IS the serving "
            "side of that dedup")
    return ServingEconConfig(quantized=quantized, cache_rows=cache_rows,
                             coalesce=coalesce)


@dataclasses.dataclass(frozen=True)
class PsServiceConfig:
    """Validated knobs of the networked PS service (``ps/service/``)."""

    shards: int
    deadline_s: float
    retries: int
    cache_rows: int
    spawn_timeout_s: float


def ps_service_conf() -> PsServiceConfig:
    """The ``ps_service_shards``, ``ps_service_deadline``,
    ``ps_service_retries``, ``ps_service_cache_rows`` and
    ``ps_service_spawn_timeout`` flags (their ``PBOX_FLAGS_*`` variables,
    read at each call), validated as the reference validates them: the one
    resolution ``ShardService``, ``ServiceClient`` and ``RemoteTable``
    share, so a bad value fails at construction."""
    shards = int(env_flag("ps_service_shards", 2))
    deadline = float(env_flag("ps_service_deadline", 5.0))
    retries = int(env_flag("ps_service_retries", 3))
    cache_rows = int(env_flag("ps_service_cache_rows", 0))
    spawn_timeout = float(env_flag("ps_service_spawn_timeout", 60.0))
    if shards < 1:
        raise ValueError(
            f"ps_service_shards must be >= 1, got {shards}")
    if deadline <= 0:
        raise ValueError(
            f"ps_service_deadline must be > 0, got {deadline} "
            "(0 would expire every request before it is sent)")
    if retries < 0:
        raise ValueError(
            f"ps_service_retries must be >= 0, got {retries}")
    if cache_rows < 0:
        raise ValueError(
            f"ps_service_cache_rows must be >= 0, got {cache_rows}")
    if 0 < cache_rows < 16:
        raise ValueError(
            f"ps_service_cache_rows ({cache_rows}) is smaller than one "
            "batch's working set; a sub-16-row cache evicts its own "
            "entries every lookup (0 disables the cache)")
    if cache_rows and not env_flag("enable_pull_padding_zero", True):
        # the cache keys rows by feasign and caches the zero row of the
        # padding key 0
        raise ValueError(
            "ps_service_cache_rows requires enable_pull_padding_zero "
            "(the cache treats feasign 0 as the padding row)")
    if spawn_timeout <= 0:
        raise ValueError(
            f"ps_service_spawn_timeout must be > 0, got {spawn_timeout}")
    return PsServiceConfig(shards=shards, deadline_s=deadline,
                           retries=retries, cache_rows=cache_rows,
                           spawn_timeout_s=spawn_timeout)
