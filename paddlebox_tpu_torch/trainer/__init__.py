"""Step engines of the port and ``CTRTrainer``, which drives them from a
dataset or straight off files: ``TrainStep`` (the step over a host
``EmbeddingTable``, and the forward that serving runs) and
``FusedTrainStep`` (the fused step over a device-resident table).

``TrainStep`` resolves at first use, so a torch-free submodule
(``trainer.donefile``, which a PS shard server's resume reads) imports no
torch."""

import importlib

__all__ = ["TrainStep"]


def __getattr__(name: str):
    if name != "TrainStep":
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = importlib.import_module(
        "paddlebox_tpu_torch.trainer.train_step").TrainStep
    globals()[name] = value
    return value
