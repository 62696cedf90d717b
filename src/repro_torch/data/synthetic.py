"""Synthetic LM batches, drawn from the same numpy stream as the
reference's ``data/synthetic.make_batch``: ``default_rng(seed*1_000_003 +
step)``, tokens first and ``vision_embeds`` second, so tokens, labels and
vision embeddings come out identical to the JAX batch."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype


def make_batch(cfg: ArchConfig, batch: int, seq: int, *, step: int = 0,
               seed: int = 0, dtype=None, device=None
               ) -> Dict[str, torch.Tensor]:
    """One training batch: tokens (B,S) int64, labels = next token, and
    ``vision_embeds`` (B, vision_tokens, d_model) for the vlm family."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet")
    rng = np.random.default_rng(seed * 1_000_003 + step)
    toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1), dtype=np.int32)
    out = {
        "tokens": torch.from_numpy(toks[:, :-1].astype(np.int64)).to(dev),
        "labels": torch.from_numpy(toks[:, 1:].astype(np.int64)).to(dev),
    }
    if cfg.family == "vlm":
        ve = rng.standard_normal((batch, cfg.vision_tokens, cfg.d_model),
                                 dtype=np.float32) * 0.02
        out["vision_embeds"] = torch.from_numpy(ve).to(dev, dt)
    return out
