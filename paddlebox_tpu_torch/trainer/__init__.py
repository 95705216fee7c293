"""Step engines of the port: the forward half of ``TrainStep`` and the
fused training step over a device-resident table."""
