"""Weight carry-over between the reference and the port.

The reference flattens its parameter pytree to numpy arrays under
``checkpoint/npz.py:_flatten`` keys (``embed/table``, ``units/attn/wq/w``
stacked per unit, ``ln_f/scale``). The port keeps the same layout,
including (d_in, d_out) linear weights, so carrying weights across is a
copy, never a transpose. The port keeps its own copy of the key scheme
(``repro_torch.tree.flatten``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import flatten, unflatten


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: reinterpret the raw 16 bits
        bits = torch.from_numpy(arr.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_numpy(flat: Dict[str, np.ndarray], *, dtype=None,
                      device=None) -> Dict:
    """Reference-flattened numpy arrays -> the port's nested parameter
    dict on ``device``, cast to ``dtype`` when given."""
    dev = resolve_device(device)
    out = {}
    for key, arr in flat.items():
        t = _to_tensor(np.asarray(arr))
        out[key] = t.to(device=dev, dtype=dtype or t.dtype)
    return unflatten(out)


def params_to_numpy(params, *, prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse: the port's nested dict -> numpy under the reference's
    keys. bfloat16 tensors come back widened to float32, which is exact;
    ``jnp.asarray(arr, dtype=bfloat16)`` on the reference side restores
    the original bits."""
    out = {}
    for key, t in flatten(params, prefix).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[key] = t.numpy()
    return out
