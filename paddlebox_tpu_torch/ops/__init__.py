"""Ops of the port: each TPU kernel's Hopper kernel beside its plain
PyTorch version, and the public ops that dispatch between them."""

from paddlebox_tpu_torch.ops.cvm import cvm
from paddlebox_tpu_torch.ops.seqpool_cvm import (fused_seqpool_cvm,
                                                 fused_seqpool_cvm_with_conv,
                                                 fused_seqpool_cvm_with_pcoc)

__all__ = ["fused_seqpool_cvm", "fused_seqpool_cvm_with_conv",
           "fused_seqpool_cvm_with_pcoc", "cvm"]
