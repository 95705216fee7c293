"""Step engines of the port (the forward half of ``TrainStep``, the fused
training step over a device-resident table) and ``CTRTrainer``, which
drives the fused step from a dataset or straight off files."""
