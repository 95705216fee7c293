"""PyTorch/CUDA port of paddlebox_tpu for one NVIDIA H100.

The JAX package ``paddlebox_tpu`` is the reference; this package mirrors its
module layout and names so each counterpart is easy to find. It imports
``torch`` and numpy only — never ``jax`` and nothing of ``paddlebox_tpu``:
what it needs of the reference's host code it keeps as its own copy.

Ported so far: the serving path of the flagship DeepFM —
``inference.predictor.CTRPredictor`` -> host pull (``ps.table``) ->
``trainer.train_step.TrainStep.predict`` -> ``ops.seqpool_cvm`` (a CUDA
kernel on the card) -> ``models.deepfm.DeepFM``.
"""

from paddlebox_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
