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
  ``PassManager`` and ``CTRTrainer``.
"""

from paddlebox_tpu_torch._device import resolve_device
from paddlebox_tpu_torch.trainer.train_step import TrainStep

__all__ = ["TrainStep", "resolve_device"]
