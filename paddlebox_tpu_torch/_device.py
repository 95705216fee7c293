"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``cuda``, and a machine without CUDA raises instead of
silently computing on the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without CUDA present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
