"""LM assembly for the dense and vlm families (the reference's
``models/model.py``), with the reference's parameter layout: every
per-layer weight is stacked with a leading ``n_units`` dimension.

Public API (params are plain nested dicts of tensors):
    init_params(cfg, seed, dtype, device) -> params
    forward(cfg, params, batch, ...)      -> (logits, aux)

Other families raise ``NotImplementedError`` naming the slice that brings
them. The reference's sharding constraints are no-ops on one device and
are left out.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.tree import unit_slice

from . import attention as attn_mod
from .layers import (embed, linear, mrope_cos_sin, normal_init, rms_norm,
                     rope_cos_sin, swiglu, unembed)

PORTED_FAMILIES = ("dense", "vlm")
_LATER = {"hybrid": "the hybrid slice (SSD kernels)",
          "moe": "the remaining-families slice",
          "ssm": "the remaining-families slice",
          "audio": "the remaining-families slice"}


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; it "
            f"comes with {_LATER.get(cfg.family, 'a later slice')}")


def init_params(cfg: ArchConfig, seed: int = 0, dtype=None, device=None
                ) -> Dict:
    """Random parameters from ``seed`` in ``dtype`` (default cfg.dtype).
    The values differ from the reference's ``jax.random`` init; tests
    carry the reference's weights across with ``checkpoint.bridge``."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n, d = cfg.n_units, cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def lin(d_in, d_out):
        return {"w": normal_init(gen, (n, d_in, d_out), dt, dev)}

    params = {
        "embed": {"table": normal_init(gen, (cfg.vocab, d), dt, dev)},
        "units": {
            "ln1": {"scale": ones(n, d)},
            "attn": attn_mod.attention_init(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                n_units=n, qkv_bias=cfg.qkv_bias, dtype=dt, device=dev),
            "ln2": {"scale": ones(n, d)},
            "mlp": {"gate": lin(d, cfg.d_ff), "up": lin(d, cfg.d_ff),
                    "down": lin(cfg.d_ff, d)},
        },
        "ln_f": {"scale": ones(d)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal_init(gen, (d, cfg.vocab), dt, dev)}
    return params


def param_count(params) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() for t in leaves(params))


# ---------------------------------------------------------------------- #
# position tables
# ---------------------------------------------------------------------- #
def _rope_tables(cfg: ArchConfig, positions: torch.Tensor):
    """positions: (S,) or (B, S). Returns (cos, sin) or (None, None)."""
    if not cfg.rope:
        return None, None
    if cfg.mrope_sections:
        pos3 = _mrope_positions(cfg, positions)
        return mrope_cos_sin(pos3, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_sections)
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _mrope_positions(cfg: ArchConfig, positions: torch.Tensor):
    """Qwen2-VL M-RoPE streams: text tokens use equal t/h/w; the stubbed
    vision prefix gets a (t=0, h, w) grid of width 32."""
    if positions.ndim == 1:
        positions = positions[None]
    grid_w = 32
    is_vis = positions < cfg.vision_tokens
    h = torch.where(is_vis, positions // grid_w, positions)
    w = torch.where(is_vis, positions % grid_w, positions)
    t = torch.where(is_vis, torch.zeros_like(positions), positions)
    return torch.stack([t, h, w])          # (3, B, S)


# ---------------------------------------------------------------------- #
# forward
# ---------------------------------------------------------------------- #
def _attn_block_fwd(p, cfg, x, cos, sin, window):
    h = attn_mod.attention(
        p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cos, sin,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, window=window)
    x = x + h
    return x + swiglu(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps))


def _make_unit_fwd(cfg: ArchConfig, cos, sin, window):
    _require_ported(cfg)

    def unit_fwd(x, p):
        return _attn_block_fwd(p, cfg, x, cos, sin, window)
    return unit_fwd


def _scan_units(x, units, n_units: int, unit_fwd, remat: bool):
    """The reference's ``lax.scan`` over stacked units as a loop. ``units``
    is the stacked dict, or a list of per-unit dicts (the gradient leaves
    of ``tree.grad_leaves``). ``remat`` recomputes each unit in the
    backward instead of keeping its activations."""
    for u in range(n_units):
        p = units[u] if isinstance(units, list) else unit_slice(units, u)
        if remat:
            x = checkpoint(unit_fwd, x, p, use_reentrant=False)
        else:
            x = unit_fwd(x, p)
    return x


def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B,S) int [, "vision_embeds" (B,Tv,D)]} ->
    (logits (B,S,V), aux). ``aux`` is 0: the dense and vlm families have
    no auxiliary loss."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dt = torch_dtype(cfg.dtype)
    x = embed(params["embed"], tokens, dt)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        tv = batch["vision_embeds"].shape[1]
        x = torch.cat([batch["vision_embeds"].to(dt), x[:, tv:]], dim=1)

    positions = torch.arange(s, device=tokens.device)
    cos, sin = _rope_tables(cfg, positions)
    unit_fwd = _make_unit_fwd(cfg, cos, sin, cfg.sliding_window)
    x = _scan_units(x, params["units"], cfg.n_units, unit_fwd, remat)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_head(cfg, params, x), aux


def _lm_head(cfg, params, x):
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return linear(params["lm_head"], x)
