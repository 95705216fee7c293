"""Serving bundles and the batch predictor of the port."""

from paddlebox_tpu_torch.inference.predictor import (CTRPredictor,
                                                     load_inference_model,
                                                     save_inference_model)

__all__ = ["CTRPredictor", "load_inference_model", "save_inference_model"]
