"""PyTorch/CUDA port of paddlebox_tpu for one NVIDIA H100.

The JAX package ``paddlebox_tpu`` is the reference; this package mirrors its
module layout and names so each counterpart is easy to find. It imports
``torch`` and numpy only — never ``jax`` and nothing of ``paddlebox_tpu``:
what it needs of the reference's host code it keeps as its own copy.

Ported so far:

- serving of every model class (``models``: DeepFM, Wide&Deep, FeedDNN,
  MMoE): ``inference.predictor.CTRPredictor`` -> device pull
  (``ps.serving_table``) -> ``trainer.train_step.TrainStep.predict`` ->
  ``ops.seqpool_cvm`` (a CUDA kernel on the card) -> the model;
- single-device training through the reference's entry point:
  ``data.dataset.SlotDataset`` (``data.parser.SlotParser``) ->
  ``trainer.trainer.CTRTrainer.train_from_dataset`` ->
  ``trainer.fused_step.FusedTrainStep`` (host prep, or device prep over
  ``ps.native`` and the index mirror ``ps.device_index``) over a
  ``ps.device_table.DeviceTable``, with hand-written CUDA kernels for the
  seqpool forward and backward, the push and the key dedup and probe;
- the host-table engine: ``CTRTrainer(use_device_table=False)`` pulls
  each batch from a host ``ps.table.EmbeddingTable``, steps
  ``trainer.train_step.TrainStep`` on the card (the seqpool kernels
  forward and backward) and pushes its embedding grads back, with the
  named ``metrics.registry.MetricRegistry``;
- the day/pass loop: ``trainer.pass_manager.PassManager`` over
  ``ps.server.SparsePS``, with delta and base saves through ``ckpt`` (the
  atomic commit, the background writer, retention, discovery), the
  donefile (``trainer.donefile``) and ``resume``, in the reference's
  checkpoint layout;
- tables larger than device memory: ``ps.tiered_table.TieredDeviceTable``,
  a bounded device arena that stages each pass's working set from the
  host ``ps.table.EmbeddingTable`` (the DRAM tier, with the host sparse
  optimizers of ``ps.optimizer``), with the asynchronous feed pass, under
  ``PassManager`` and ``CTRTrainer``;
- the data feed: ``pipe_command`` under its watchdog, error budgets with
  their quarantine, the multi-process reader ``data.fast_feed.
  MultiProcessReader`` over the shared-memory fabric (``data.
  shm_fabric``), merge by instance id, the in-process shuffles, the
  record archive and ``InputTableDataset``;
- lifecycle and observability: the metrics registry, the Chrome trace and
  the heartbeat (``obs``), the train guard with its rollback
  (``trainer.guard``), the postmortem bundle (``obs.postmortem``), the
  section profiler (``trainer.profiler``), the reference user's
  ``compat.BoxPSDataset`` and ``utils.fs.FileMgr``;
- the device-sharded mesh engine: ``CTRTrainer(mesh=...)`` over a
  ``parallel.mesh.Mesh`` (one controller, a shard a device) ->
  ``parallel.fused_dp_step.FusedShardedTrainStep`` over a
  ``ps.sharded_device_table.ShardedDeviceTable``, host plan or device
  prep, the requester's gradient merge a CUDA kernel.

The package's top-level names resolve at first use, so a module that
needs no torch (the data feed's parse workers import ``data.fast_feed``)
imports none.
"""

import importlib

_LAZY = {"TrainStep": "paddlebox_tpu_torch.trainer.train_step",
         "resolve_device": "paddlebox_tpu_torch._device"}

__all__ = ["TrainStep", "resolve_device"]


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
