"""Serving bundles and the batch predictor of the port.

The names load at first use (PEP 562): ``inference.server`` and the
serving tier's front door import no torch until a predictor is built, so
a serving host of stand-in predictors starts without it.
"""

import importlib

_LAZY = {
    "CTRPredictor": "paddlebox_tpu_torch.inference.predictor",
    "load_inference_model": "paddlebox_tpu_torch.inference.predictor",
    "register_model_class": "paddlebox_tpu_torch.inference.predictor",
    "save_inference_model": "paddlebox_tpu_torch.inference.predictor",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = ["CTRPredictor", "load_inference_model", "register_model_class",
           "save_inference_model"]
