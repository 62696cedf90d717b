"""The four input shapes of the dry-run and the ``meta`` tensors that
stand in for their inputs (the reference's ``configs/shapes.py``); no
memory is allocated.

  train_4k     seq_len=  4,096  global_batch=256   train step
  prefill_32k  seq_len= 32,768  global_batch= 32   prefill forward
  decode_32k   seq_len= 32,768  global_batch=128   decode step (1 token +
                                                   KV cache of seq_len)
  long_500k    seq_len=524,288  global_batch=  1   decode step, sub-quadratic
                                                   archs only

Token ids are int64, torch's index type (the reference's are int32).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.device import torch_dtype

from .base import ArchConfig

# sliding window of the long-context variant of full-attention archs
LONG_CTX_WINDOW = 8192


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    """None if (cfg, shape) runs; else the reason it is skipped."""
    if shape.name == "long_500k" and cfg.family == "audio":
        return ("enc-dec whisper decoder is trained for 448 positions; "
                "0.5M-token decode is out of family semantics "
                "(DESIGN.md §5)")
    return None


def variant_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """long_500k on full-attention families takes the sliding-window
    sub-quadratic variant; SSM and hybrid run natively."""
    if (shape.name == "long_500k" and cfg.family in ("dense", "vlm", "moe")
            and cfg.sliding_window == 0):
        return dataclasses.replace(cfg, sliding_window=LONG_CTX_WINDOW)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, object]:
    """``meta`` stand-ins for every model input of this shape.

    train / prefill: the token batch (+ the stubbed frontends'
    embeddings). decode: one new token a sequence and the decode cache
    (KV cache of ``seq_len`` rows, or the recurrent state), from
    ``init_cache`` on ``meta``.
    """
    cfg = variant_for_shape(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _meta((b, s), torch.long)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, s), torch.long)
        if cfg.family == "vlm":
            specs["vision_embeds"] = _meta((b, cfg.vision_tokens,
                                            cfg.d_model), dt)
        if cfg.family == "audio":
            specs["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), dt)
        return specs
    from repro_torch.models.model import init_cache
    cache = init_cache(cfg, b, s, dt, device="meta")
    return {"tokens": _meta((b, 1), torch.long), "cache": cache}
