"""Synthetic LM batches, drawn from the same numpy stream as the
reference's ``data/synthetic.make_batch``: ``default_rng(seed*1_000_003 +
step)``, tokens first, then ``vision_embeds`` (vlm) or ``frames``
(audio), so tokens, labels and the stubbed frontends' embeddings come
out identical to the JAX batch."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype


def make_batch(cfg: ArchConfig, batch: int, seq: int, *, step: int = 0,
               seed: int = 0, dtype=None, structured: bool = False,
               device=None) -> Dict[str, torch.Tensor]:
    """One training batch: tokens (B,S) int64, labels = next token,
    ``vision_embeds`` (B, vision_tokens, d_model) for the vlm family and
    ``frames`` (B, encoder_seq, d_model), the stubbed audio frontend's
    output, for the audio family (the others take tokens only).

    ``structured=True`` draws deterministic affine sequences
    t_{i+1} = (a*t_i + b) mod V: i.i.d. uniform tokens have an
    irreducible loss of ln(V), so a demo that must show learning (the
    quickstart) needs learnable structure."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    rng = np.random.default_rng(seed * 1_000_003 + step)
    if structured:
        a = 5 * (seed % 97) + 3
        bconst = (seed % 1009) + 1
        start = rng.integers(0, cfg.vocab, size=(batch, 1), dtype=np.int64)
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, :1] = start
        for i in range(seq):
            toks[:, i + 1] = (a * toks[:, i] + bconst) % cfg.vocab
        toks = toks.astype(np.int32)
    else:
        toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1),
                            dtype=np.int32)
    out = {
        "tokens": torch.from_numpy(toks[:, :-1].astype(np.int64)).to(dev),
        "labels": torch.from_numpy(toks[:, 1:].astype(np.int64)).to(dev),
    }
    if cfg.family == "vlm":
        ve = rng.standard_normal((batch, cfg.vision_tokens, cfg.d_model),
                                 dtype=np.float32) * 0.02
        out["vision_embeds"] = torch.from_numpy(ve).to(dev, dt)
    if cfg.family == "audio":
        fr = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model),
                                 dtype=np.float32) * 0.02
        out["frames"] = torch.from_numpy(fr).to(dev, dt)
    return out


class SyntheticLM:
    """Iterator over deterministic synthetic batches (step 0, 1, ...)."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                 dtype=None, structured: bool = False, device=None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.dtype = seed, dtype
        self.structured = structured
        self.device = resolve_device(device)
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = make_batch(self.cfg, self.batch, self.seq, step=self._step,
                       seed=self.seed, dtype=self.dtype,
                       structured=self.structured, device=self.device)
        self._step += 1
        return b
