"""LM assembly for the dense, vlm, hybrid and moe families (the
reference's ``models/model.py``), with the reference's parameter layout:
every per-layer weight is stacked with a leading ``n_units`` dimension;
the hybrid's Mamba2 layers carry a second, (n_units, layers per unit,
...), and its one shared attention block is not stacked. A moe unit is
``pattern_unit()`` layers under ``sub0``, ``sub1``, ...: dense attention
blocks, then the MoE layer last (llama4-maverick: a dense ``sub0`` and a
MoE ``sub1``; granite-moe: a MoE ``sub0`` alone).

Public API (params are plain nested dicts of tensors):
    init_params(cfg, seed, dtype, device) -> params
    forward(cfg, params, batch, ...)      -> (logits, aux)
    init_cache / init_paged_cache         -> decode cache
    prefill / prefill_extend / decode_step (serving)

Decode caches are linear (row t holds position t), or, for a config with
a sliding window, a ring buffer of min(window, max_len) rows (position t
in row t % rows), as in the reference. The hybrid's cache holds, per
unit, each Mamba2 layer's conv window and SSM state, stacked (n_units,
layers per unit, B, ...), and one K/V cache per application of the
shared block, stacked (n_units, B, ...); a moe unit's holds one K/V cache
per layer, under the layer's ``sub{i}``. The ssm and audio families
raise ``NotImplementedError`` naming the slice that brings them. The
reference's sharding constraints are no-ops on one device and are left
out.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.tree import unit_slice

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (embed, linear, mrope_cos_sin, normal_init, rms_norm,
                     rope_cos_sin, swiglu, unembed)

FAMILIES = ("dense", "vlm", "hybrid", "moe")     # trained and served
_LATER = {"ssm": "the remaining-families slice",
          "audio": "the remaining-families slice"}


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; "
            f"it comes with {_LATER.get(cfg.family, 'a later slice')}")


def layered_units(cfg: ArchConfig) -> Tuple[str, ...]:
    """The unit subtrees whose leaves stack the unit's layers a second
    time, (n_units, layers per unit, ...): the hybrid's Mamba2 layers."""
    return ("mamba",) if cfg.family == "hybrid" else ()


def init_params(cfg: ArchConfig, seed: int = 0, dtype=None, device=None
                ) -> Dict:
    """Random parameters from ``seed`` in ``dtype`` (default cfg.dtype).
    The values differ from the reference's ``jax.random`` init; tests
    carry the reference's weights across with ``checkpoint.bridge``.
    ``device="meta"`` gives the shapes alone (no memory, no values)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    n, d = cfg.n_units, cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def attn_block(lead, moe=False):
        def lin(d_in, d_out):
            return {"w": normal_init(gen, lead + (d_in, d_out), dt, dev)}
        block = {
            "ln1": {"scale": ones(*lead, d)},
            "attn": attn_mod.attention_init(
                gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                n_units=lead[0] if lead else None, qkv_bias=cfg.qkv_bias,
                dtype=dt, device=dev),
            "ln2": {"scale": ones(*lead, d)},
        }
        if moe:
            block["ffn"] = moe_mod.moe_init(
                gen, d, cfg.moe_experts, cfg.moe_d_ff or cfg.d_ff,
                shared_expert=cfg.moe_shared_expert, pad_to=cfg.moe_pad_to,
                lead=lead, dtype=dt, device=dev)
        else:
            block["mlp"] = {"gate": lin(d, cfg.d_ff), "up": lin(d, cfg.d_ff),
                            "down": lin(cfg.d_ff, d)}
        return block

    params = {"embed": {"table": normal_init(gen, (cfg.vocab, d), dt, dev)},
              "ln_f": {"scale": ones(d)}}
    if cfg.family == "hybrid":     # zamba2: u Mamba2 layers (+ shared attn)
        lead = (n, cfg.pattern_unit())
        params["units"] = {"mamba": {
            "ln": {"scale": ones(*lead, d)},
            "mamba": ssm_mod.mamba2_init(
                gen, d, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                cfg.ssm_conv, lead=lead, dtype=dt, device=dev)}}
        if cfg.attn_every:
            params["shared_attn"] = attn_block(())
    elif cfg.family == "moe":      # dense layers, then the MoE layer
        u = cfg.pattern_unit()
        params["units"] = {f"sub{i}": attn_block((n,), moe=i == u - 1)
                           for i in range(u)}
    else:
        params["units"] = attn_block((n,))
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
def _ffn_block(p, cfg, x):
    """x + the block's FFN on its normed input: the SwiGLU MLP, or, for a
    MoE layer (``"ffn"``), the routed experts. Returns (x, the MoE
    layer's aux loss or None)."""
    xn = rms_norm(p["ln2"], x, cfg.norm_eps)
    if "ffn" not in p:
        return x + swiglu(p["mlp"], xn), None
    y, aux = moe_mod.moe_forward(
        p["ffn"], xn, n_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor, dispatch=cfg.moe_dispatch)
    return x + y, aux


def _attn_block_fwd(p, cfg, x, cos, sin, window):
    h = attn_mod.attention(
        p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cos, sin,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, window=window)
    return _ffn_block(p, cfg, x + h)


def _layers(stack, n: int):
    """The per-layer trees of a layer stack: its list of per-layer
    gradient leaves (``tree.grad_leaves``), or views of the stacked
    tensors."""
    return stack if isinstance(stack, list) else [
        unit_slice(stack, i) for i in range(n)]


def _make_unit_fwd(cfg: ArchConfig, shared_attn, cos, sin, window):
    """(x, unit params) -> (x, the unit's summed MoE aux loss, f32)."""
    _require_ported(cfg)

    def zero(x):
        return torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family == "moe":
        def unit_fwd(x, p):
            aux = zero(x)
            for i in range(cfg.pattern_unit()):
                x, a = _attn_block_fwd(p[f"sub{i}"], cfg, x, cos, sin,
                                       window)
                if a is not None:
                    aux = aux + a
            return x, aux
        return unit_fwd
    if cfg.family != "hybrid":
        def unit_fwd(x, p):
            return _attn_block_fwd(p, cfg, x, cos, sin, window)[0], zero(x)
        return unit_fwd

    def unit_fwd(x, p):
        for lp in _layers(p["mamba"], cfg.pattern_unit()):
            x = x + ssm_mod.mamba2_forward(
                lp["mamba"], rms_norm(lp["ln"], x, cfg.norm_eps),
                d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                n_heads=cfg.n_ssm_heads)
        if shared_attn is not None:
            x = _attn_block_fwd(shared_attn, cfg, x, cos, sin, window)[0]
        return x, zero(x)
    return unit_fwd


def _scan_units(x, units, n_units: int, unit_fwd, remat: bool):
    """The reference's ``lax.scan`` over stacked units as a loop, summing
    the units' aux losses in unit order. ``units`` is the stacked dict,
    or a list of per-unit dicts (the gradient leaves of
    ``tree.grad_leaves``). ``remat`` recomputes each unit in the backward
    instead of keeping its activations. Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(n_units):
        p = units[u] if isinstance(units, list) else unit_slice(units, u)
        if remat:
            x, a = checkpoint(unit_fwd, x, p, use_reentrant=False)
        else:
            x, a = unit_fwd(x, p)
        aux = aux + a
    return x, aux


def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B,S) int [, "vision_embeds" (B,Tv,D)]} ->
    (logits (B,S,V), aux). ``aux`` is the sum of the MoE layers'
    load-balance losses (0 for the dense, vlm and hybrid families)."""
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
    unit_fwd = _make_unit_fwd(cfg, params.get("shared_attn"), cos, sin,
                              cfg.sliding_window)
    x, aux = _scan_units(x, params["units"], cfg.n_units, unit_fwd, remat)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return _lm_head(cfg, params, x), aux


def _lm_head(cfg, params, x):
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return linear(params["lm_head"], x)


# ---------------------------------------------------------------------- #
# decode (serving)
# ---------------------------------------------------------------------- #
def _kv_cache(shape, dt, dev):
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def has_linear_kv(cfg: ArchConfig) -> bool:
    """Whether decode writes one K/V row per absolute position, so that a
    prompt and its new tokens must fit ``max_len`` and the K/V leaves can
    be paged (the reference's ``engine._has_linear_kv``): the dense, vlm
    and moe families, and the hybrid when it has a shared attention
    block. A sliding window's ring buffer wraps instead."""
    if cfg.sliding_window > 0:
        return False
    return cfg.family in ("dense", "vlm", "moe") or (
        cfg.family == "hybrid" and cfg.attn_every > 0)


def _require_linear(cfg: ArchConfig, what: str) -> None:
    """``what`` needs the linear cache layout, which the reference gives
    only a config without a window (``init_paged_cache``,
    ``prefill_extend``)."""
    _require_ported(cfg)
    if cfg.sliding_window:
        raise ValueError(
            f"{what} needs the linear cache layout; {cfg.name} has a "
            f"sliding window ({cfg.sliding_window}) and decodes over a "
            f"ring buffer")


def _unit_caches(cfg: ArchConfig, batch: int, kv_shape, dt, dev) -> Dict:
    """The per-unit cache tree, stacked over units: the K/V leaves of
    shape (n_units,) + ``kv_shape``; for the hybrid, under "shared" (one
    K/V cache per application of the shared block), beside each Mamba2
    layer's dense per-slot conv window and state under "mamba"; for moe,
    one K/V cache per layer of the unit, under "sub{i}"."""
    if cfg.family == "moe":
        return {f"sub{i}": _kv_cache((cfg.n_units,) + kv_shape, dt, dev)
                for i in range(cfg.pattern_unit())}
    kv = _kv_cache((cfg.n_units,) + kv_shape, dt, dev)
    if cfg.family != "hybrid":
        return kv
    return {"mamba": ssm_mod.mamba2_init_cache(
                batch, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                cfg.ssm_conv, lead=(cfg.n_units, cfg.pattern_unit()),
                dtype=dt, device=dev),
            "shared": kv}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict:
    """Zeroed decode cache: {"units": {"k", "v"} (n_units, B, rows, Hkv,
    D), "index": 0-dim int64}, where rows is ``max_len`` (linear), or
    min(window, max_len) for a sliding window (a ring buffer, as the
    reference allocates it). For the hybrid "units" is {"mamba":
    {"conv" (n_units, u, B, d_conv - 1, C), "state" (n_units, u, B, H, P,
    N) f32}, "shared": {"k", "v"}}; for moe {"sub{i}": {"k", "v"}}."""
    _require_ported(cfg)
    dev = resolve_device(device)
    w = cfg.sliding_window
    rows = min(w, max_len) if w else max_len
    kv_shape = (batch, rows, cfg.n_kv_heads, cfg.head_dim)
    return {"units": _unit_caches(cfg, batch, kv_shape,
                                  torch_dtype(dtype or cfg.dtype), dev),
            "index": torch.zeros((), dtype=torch.long, device=dev)}


def init_paged_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                     page_size: int, n_pages: int, dtype=None,
                     device=None) -> Dict:
    """Paged decode cache: the K/V leaves become shared pools
    (n_units, n_pages + 1, page_size, Hkv, D) addressed through one block
    table ``pages``: (batch, max_len // page_size) int32, -1 =
    unassigned. Pool page ``n_pages`` is a scratch page that no table
    entry names: a decode write with no page of its own lands there (the
    reference drops it with an out-of-bounds scatter). The hybrid's
    Mamba2 leaves stay dense per slot: they are O(1) per slot, not
    O(max_len). Linear layout only, as in the reference."""
    _require_linear(cfg, "paged KV")
    if max_len % page_size:
        raise ValueError(f"max_len {max_len} is not a multiple of "
                         f"page_size {page_size}")
    dev = resolve_device(device)
    kv_shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"units": _unit_caches(cfg, batch, kv_shape,
                                  torch_dtype(dtype or cfg.dtype), dev),
            "index": torch.zeros((), dtype=torch.long, device=dev),
            "pages": torch.full((batch, max_len // page_size), -1,
                                dtype=torch.int32, device=dev)}


def _akw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim)


def _serve_units(cfg: ArchConfig, params, cache, x, mamba_fn, attn_fn):
    """Every unit over the decode cache, in place: ``attn_fn(attention
    params, normed x, K/V cache)`` for each attention block (the hybrid's
    shared block once per unit, with that application's K/V cache; each
    layer of a moe unit with its own), each block's FFN (MLP or MoE
    experts), and, for the hybrid, ``mamba_fn`` (``ssm.mamba2_prefill``
    or ``mamba2_decode``) for each Mamba2 layer with its cache."""
    eps = cfg.norm_eps
    shared = params.get("shared_attn")
    for u in range(cfg.n_units):
        p = unit_slice(params["units"], u)
        c = unit_slice(cache["units"], u)
        if cfg.family == "hybrid":
            for i in range(cfg.pattern_unit()):
                lp, lc = unit_slice(p["mamba"], i), unit_slice(c["mamba"], i)
                h, _ = mamba_fn(lp["mamba"], rms_norm(lp["ln"], x, eps), lc,
                                d_inner=cfg.d_inner,
                                ssm_state=cfg.ssm_state,
                                n_heads=cfg.n_ssm_heads)
                x = x + h
            blocks = [] if shared is None else [(shared, c["shared"])]
        elif cfg.family == "moe":
            blocks = [(p[f"sub{i}"], c[f"sub{i}"])
                      for i in range(cfg.pattern_unit())]
        else:
            blocks = [(p, c)]
        for bp, bc in blocks:
            h, _ = attn_fn(bp["attn"], rms_norm(bp["ln1"], x, eps), bc)
            x, _ = _ffn_block(bp, cfg, x + h)
    return x


@torch.no_grad()
def prefill(cfg: ArchConfig, params, cache, tokens
            ) -> Tuple[torch.Tensor, Dict]:
    """One-shot prefill of a fresh cache (index 0) from the whole prompt.
    tokens: (B, S) int. Writes the prompt's K/V rows (for a sliding
    window, its last min(S, rows) positions into ring rows t % rows; for
    the hybrid, also each Mamba2 layer's conv window and SSM state after
    the prompt) in place and returns (logits (B, S, V), cache with
    ``index`` S)."""
    _require_ported(cfg)
    b, s = tokens.shape
    x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    cos, sin = _rope_tables(cfg, torch.arange(s, device=tokens.device))

    def attn(p, xn, kv):
        return attn_mod.attention_prefill(p, xn, cos, sin, kv,
                                          window=cfg.sliding_window,
                                          **_akw(cfg))
    x = _serve_units(cfg, params, cache, x, ssm_mod.mamba2_prefill, attn)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["index"] = torch.full_like(cache["index"], s)
    return _lm_head(cfg, params, x), new_cache


@torch.no_grad()
def prefill_extend(cfg: ArchConfig, params, cache, tokens, *,
                   start: int) -> Tuple[torch.Tensor, Dict]:
    """Suffix prefill: continue a linear cache whose rows ``[0, start)``
    are filled (the prefix-sharing engine gathers a matched prompt prefix
    out of the page pool) and compute only the suffix. tokens:
    (B, S_suffix) at absolute positions ``start .. start + S - 1``.
    Returns (logits (B, S_suffix, V), cache with index start + S). Only
    for families whose per-layer state is position-local: the hybrid's
    conv window and SSM state would need a snapshot at ``start``. A MoE
    layer routes the suffix's tokens alone: its rows are the whole
    prefill's only under ``moe_dispatch="dense"``, whose rows do not
    depend on the call's other tokens."""
    _require_linear(cfg, "prefill_extend")
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(
            f"prefill_extend needs position-local state; family "
            f"{cfg.family!r} carries recurrent state across positions "
            f"(the Mamba2 conv window and SSM state)")
    b, s = tokens.shape
    x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    cos, sin = _rope_tables(
        cfg, torch.arange(start, start + s, device=tokens.device))

    def attn(p, xn, kv):
        return attn_mod.attention_prefill_extend(p, xn, cos, sin, kv,
                                                 start=start, **_akw(cfg))
    x = _serve_units(cfg, params, cache, x, None, attn)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["index"] = torch.full_like(cache["index"], start + s)
    return _lm_head(cfg, params, x), new_cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params, cache, tokens, *, index=None
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, 1) int; ``index``: absolute position, 0-dim or per
    example (B,), on the cache's device (default ``cache["index"]``).
    Writes one K/V row per example (row ``index``, or ``index % rows``
    in a sliding window's ring; for the hybrid, also steps each Mamba2
    layer's conv window and SSM state) in place and returns (logits
    (B, 1, V), cache with index + 1). With ``cache["pages"]`` the cache is
    paged and attention takes the paged flash-decode kernel on the card;
    else the linear one, for the ring too."""
    _require_ported(cfg)
    b = tokens.shape[0]
    idx = cache["index"] if index is None else index
    vec = idx.expand(b) if idx.ndim == 0 else idx
    x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    cos, sin = _rope_tables(cfg, vec[:, None])
    pages = cache.get("pages")

    def attn(p, xn, kv):
        return attn_mod.attention_decode(p, xn, cos, sin, kv, vec,
                                         pages=pages,
                                         window=cfg.sliding_window,
                                         **_akw(cfg))
    x = _serve_units(cfg, params, cache, x, ssm_mod.mamba2_decode, attn)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["index"] = idx + 1
    return _lm_head(cfg, params, x), new_cache
