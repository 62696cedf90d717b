"""Device and dtype resolution shared by the entry points of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. A CUDA device with no GPU present raises:
    the port never moves to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's dtype name) or a torch
    dtype -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))
