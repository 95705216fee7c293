"""Ops of the port: each TPU kernel's Hopper kernel beside its plain
PyTorch version, and the public ops that dispatch between them.

The public ops resolve at first use, so importing a torch-free submodule
(``ops._build``, which the data feed's parse workers load through
``ps.native``) imports no torch. ``ops.cvm`` is the op, as before, even
once the submodule of that name is imported."""

import importlib
import sys
import types

_PUBLIC = {"cvm": "cvm",
           "fused_seqpool_cvm": "seqpool_cvm",
           "fused_seqpool_cvm_with_conv": "seqpool_cvm",
           "fused_seqpool_cvm_with_pcoc": "seqpool_cvm"}

__all__ = ["fused_seqpool_cvm", "fused_seqpool_cvm_with_conv",
           "fused_seqpool_cvm_with_pcoc", "cvm"]


def __getattr__(name: str):
    module = _PUBLIC.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


class _Ops(types.ModuleType):
    def __setattr__(self, name, value):
        # the import system binds a loaded submodule as an attribute of
        # its package: the submodule ``cvm`` must not hide the op ``cvm``
        if name in _PUBLIC and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Ops
