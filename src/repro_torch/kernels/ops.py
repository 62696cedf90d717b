"""Model-layout entry to the attention kernels (the reference's
``kernels/ops.py:flash_attention``). Routing is by the tensor's device
inside each kernel wrapper: CUDA launches the kernel, CPU takes the plain
version. Tiles are fixed at 64 x 64: the reference's 128 x 128 defaults
(``autotune.DEFAULTS``) are TPU tiles, and f32 tiles of 128 rows would
not fit a block's shared memory. Autotuning is a later slice."""
from __future__ import annotations

from . import flash_attention as _flash


def flash_attention(q, k, v, *, causal=True, window=0):
    """q/k/v: (B, S, H, D) (model layout) -> (B, S, H, D). Differentiable
    in q, k, v; any sequence length."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = _flash.flash_attention(qt, kt, vt, causal=causal, window=window)
    return out.transpose(1, 2)
