"""Step engines of the port and ``CTRTrainer``, which drives them from a
dataset or straight off files: ``TrainStep`` (the step over a host
``EmbeddingTable``, and the forward that serving runs) and
``FusedTrainStep`` (the fused step over a device-resident table)."""

from paddlebox_tpu_torch.trainer.train_step import TrainStep

__all__ = ["TrainStep"]
