"""LM assembly for the dense, vlm, hybrid, moe, ssm and audio families
(the reference's ``models/model.py``), with the reference's parameter
layout: every per-layer weight is stacked with a leading ``n_units``
dimension; the hybrid's Mamba2 layers and the ssm family's mLSTM layers
carry a second, (n_units, layers per unit, ...), and the hybrid's one
shared attention block is not stacked. A moe unit is ``pattern_unit()``
layers under ``sub0``, ``sub1``, ...: dense attention blocks, then the
MoE layer last (llama4-maverick: a dense ``sub0`` and a MoE ``sub1``;
granite-moe: a MoE ``sub0`` alone). An ssm (xLSTM) unit is
``pattern_unit() - 1`` mLSTM layers under ``mlstm`` and one sLSTM layer
under ``slstm``. The audio family (Whisper) is an encoder-decoder: its
encoder stack, ``encoder/units``, leads with ``encoder_layers``; each
decoder unit has self-attention, cross-attention (``xattn``) over the
encoder's output and a GELU MLP, with sinusoidal positions.

Public API (params are plain nested dicts of tensors):
    init_params(cfg, seed, dtype, device) -> params
    forward(cfg, params, batch, ...)      -> (logits, aux)
    init_cache / init_paged_cache         -> decode cache
    prefill_cache_whisper                 -> audio: encoder + cross K/V
    prefill / prefill_extend / decode_step (serving)

Decode caches are linear (row t holds position t), or, for a config with
a sliding window, a ring buffer of min(window, max_len) rows (position t
in row t % rows), as in the reference. The hybrid's cache holds, per
unit, each Mamba2 layer's conv window and SSM state, stacked (n_units,
layers per unit, B, ...), and one K/V cache per application of the
shared block, stacked (n_units, B, ...); a moe unit's holds one K/V cache
per layer, under the layer's ``sub{i}``; an ssm unit's each mLSTM
layer's (C, n, m), stacked (n_units, mLSTM layers per unit, B, ...), and
the sLSTM's (h, c, n, m); an audio unit's its self-attention K/V under
``self`` and the encoder's K/V for its cross-attention under ``cross``,
with the count of encoder rows they hold in the cache's ``cross_len``
(a host int).

The reference's sharding constraints are kept at its choke points
(``constrain``: the residual stream ``act_btd`` after the embedding and
after each block, the ``logits``): the identity on plain tensors, a
redistribution of DTensors inside a rules context (``sharding.hooks``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.sharding.hooks import constrain
from repro_torch.tree import unit_slice
from repro_torch.util.spans import span

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import (embed, gelu_mlp, gelu_mlp_init, linear, mrope_cos_sin,
                     normal_init, rms_norm, rope_cos_sin,
                     sinusoidal_positions, swiglu, unembed)


def layered_units(cfg: ArchConfig) -> Tuple[str, ...]:
    """The unit subtrees whose leaves stack the unit's layers a second
    time, (n_units, layers per unit, ...): the hybrid's Mamba2 layers and
    the ssm family's mLSTM layers."""
    return {"hybrid": ("mamba",), "ssm": ("mlstm",)}.get(cfg.family, ())


def _n_mlstm(cfg: ArchConfig) -> int:
    """mLSTM layers a unit (the unit's last layer is the sLSTM)."""
    return max(1, cfg.pattern_unit() - 1)


def init_params(cfg: ArchConfig, seed: int = 0, dtype=None, device=None
                ) -> Dict:
    """Random parameters from ``seed`` in ``dtype`` (default cfg.dtype).
    The values differ from the reference's ``jax.random`` init; tests
    carry the reference's weights across with ``checkpoint.bridge``.
    ``device="meta"`` gives the shapes alone (no memory, no values)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    n, d = cfg.n_units, cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def attn(lead, n_kv_heads, qkv_bias):
        return attn_mod.attention_init(
            gen, d, cfg.n_heads, n_kv_heads, cfg.head_dim,
            n_units=lead[0] if lead else None, qkv_bias=qkv_bias, dtype=dt,
            device=dev)

    def attn_block(lead, moe=False):
        def lin(d_in, d_out):
            return {"w": normal_init(gen, lead + (d_in, d_out), dt, dev)}
        block = {
            "ln1": {"scale": ones(*lead, d)},
            "attn": attn(lead, cfg.n_kv_heads, cfg.qkv_bias),
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
    elif cfg.family == "ssm":      # xlstm: (u - 1) mLSTM + 1 sLSTM
        lead = (n, _n_mlstm(cfg))
        params["units"] = {"mlstm": {
            "ln": {"scale": ones(*lead, d)},
            "mlstm": xlstm_mod.mlstm_init(gen, d, cfg.d_inner, cfg.n_heads,
                                          lead=lead, dtype=dt, device=dev)}}
        if cfg.slstm_every:
            params["units"]["slstm"] = {
                "ln": {"scale": ones(n, d)},
                "slstm": xlstm_mod.slstm_init(gen, d, cfg.n_heads,
                                              lead=(n,), dtype=dt,
                                              device=dev)}
    elif cfg.family == "audio":    # whisper: decoder units + the encoder
        def audio_block(lead, decoder):
            # the reference's layout: the decoder's self-attention has
            # n_kv_heads (whisper's equal n_heads), its cross-attention and
            # the encoder's n_heads
            block = {"ln1": {"scale": ones(*lead, d)},
                     "attn": attn(lead, cfg.n_kv_heads if decoder
                                  else cfg.n_heads, False),
                     "ln2": {"scale": ones(*lead, d)},
                     "mlp": gelu_mlp_init(gen, d, cfg.d_ff, lead=lead,
                                          dtype=dt, device=dev)}
            if decoder:
                block["lnx"] = {"scale": ones(*lead, d)}
                block["xattn"] = attn(lead, cfg.n_heads, False)
            return block
        params["units"] = audio_block((n,), decoder=True)
        params["encoder"] = {
            "units": audio_block((cfg.encoder_layers,), decoder=False),
            "ln_f": {"scale": ones(d)}}
    elif cfg.family in ("dense", "vlm"):
        params["units"] = attn_block((n,))
    else:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
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
        return constrain(x + swiglu(p["mlp"], xn), "act_btd"), None
    y, aux = moe_mod.moe_forward(
        p["ffn"], xn, n_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor, dispatch=cfg.moe_dispatch)
    return constrain(x + y, "act_btd"), aux


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


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _make_unit_fwd(cfg: ArchConfig, shared_attn, cos, sin, window):
    """(x, unit params) -> (x, the unit's summed MoE aux loss, f32)."""

    if cfg.family == "moe":
        def unit_fwd(x, p):
            aux = _zero(x)
            for i in range(cfg.pattern_unit()):
                x, a = _attn_block_fwd(p[f"sub{i}"], cfg, x, cos, sin,
                                       window)
                if a is not None:
                    aux = aux + a
            return x, aux
        return unit_fwd
    if cfg.family == "ssm":
        def unit_fwd(x, p):
            for lp in _layers(p["mlstm"], _n_mlstm(cfg)):
                x = constrain(x + xlstm_mod.mlstm_forward(
                    lp["mlstm"], rms_norm(lp["ln"], x, cfg.norm_eps),
                    d_inner=cfg.d_inner, n_heads=cfg.n_heads), "act_btd")
            if "slstm" in p:
                x = constrain(x + xlstm_mod.slstm_forward(
                    p["slstm"]["slstm"],
                    rms_norm(p["slstm"]["ln"], x, cfg.norm_eps),
                    n_heads=cfg.n_heads), "act_btd")
            return x, _zero(x)
        return unit_fwd
    if cfg.family != "hybrid":
        def unit_fwd(x, p):
            return _attn_block_fwd(p, cfg, x, cos, sin, window)[0], _zero(x)
        return unit_fwd

    def unit_fwd(x, p):
        for lp in _layers(p["mamba"], cfg.pattern_unit()):
            x = constrain(x + ssm_mod.mamba2_forward(
                lp["mamba"], rms_norm(lp["ln"], x, cfg.norm_eps),
                d_inner=cfg.d_inner, ssm_state=cfg.ssm_state,
                n_heads=cfg.n_ssm_heads), "act_btd")
        if shared_attn is not None:
            x = _attn_block_fwd(shared_attn, cfg, x, cos, sin, window)[0]
        return x, _zero(x)
    return unit_fwd


def _scan_units(x, units, n_units: int, unit_fwd, remat: bool):
    """The reference's ``lax.scan`` over stacked units as a loop, summing
    the units' aux losses in unit order. ``units`` is the stacked dict,
    or a list of per-unit dicts (the gradient leaves of
    ``tree.grad_leaves``). ``remat`` recomputes each unit in the backward
    instead of keeping its activations; each unit's span opens inside
    what ``checkpoint`` runs, so it opens again in the recompute.
    Returns (x, aux)."""
    def unit(x, p):
        with span("repro_torch.model.unit"):
            return unit_fwd(x, p)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(n_units):
        p = units[u] if isinstance(units, list) else unit_slice(units, u)
        if remat:
            x, a = checkpoint(unit, x, p, use_reentrant=False)
        else:
            x, a = unit(x, p)
        aux = aux + a
    return x, aux


def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B,S) int [, "vision_embeds" (B,Tv,D), "frames"
    (B,Senc,D)]} -> (logits (B,S,V), aux). ``aux`` is the sum of the MoE
    layers' load-balance losses (0 for the other families)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dt = torch_dtype(cfg.dtype)
    x = embed(params["embed"], tokens, dt)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        tv = batch["vision_embeds"].shape[1]
        x = torch.cat([batch["vision_embeds"].to(dt), x[:, tv:]], dim=1)
    x = constrain(x, "act_btd")
    if cfg.is_encoder_decoder:
        enc = encode(cfg, params, batch["frames"], remat=remat)
        return _decoder_forward(cfg, params, x, enc, remat=remat)

    positions = torch.arange(s, device=tokens.device)
    cos, sin = _rope_tables(cfg, positions)
    unit_fwd = _make_unit_fwd(cfg, params.get("shared_attn"), cos, sin,
                              cfg.sliding_window)
    x, aux = _scan_units(x, params["units"], cfg.n_units, unit_fwd, remat)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return _lm_head(cfg, params, x), aux


def _lm_head(cfg, params, x):
    if cfg.tie_embeddings:
        return constrain(unembed(params["embed"], x), "logits")
    return constrain(linear(params["lm_head"], x), "logits")


# ---------------------------------------------------------------------- #
# whisper encoder / decoder
# ---------------------------------------------------------------------- #
def _positions(cfg: ArchConfig, positions: torch.Tensor, dt):
    return sinusoidal_positions(positions, cfg.d_model).to(dt)


def encode(cfg: ArchConfig, params, frames, *, remat: bool = True):
    """frames: (B, Senc, D), the stubbed conv frontend's output ->
    (B, Senc, D): non-causal self-attention over every frame, with
    sinusoidal positions, through ``encoder_layers`` layers."""
    dt = torch_dtype(cfg.dtype)
    s = frames.shape[1]
    x = frames.to(dt) + _positions(
        cfg, torch.arange(s, device=frames.device), dt)[None]

    def unit_fwd(x, p):
        h = attn_mod.attention(
            p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), None, None,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_heads,
            head_dim=cfg.head_dim, causal=False)
        x = x + h
        x = x + gelu_mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps))
        return constrain(x, "act_btd"), _zero(x)

    x, _ = _scan_units(x, params["encoder"]["units"], cfg.encoder_layers,
                       unit_fwd, remat)
    return rms_norm(params["encoder"]["ln_f"], x, cfg.norm_eps)


def _decoder_forward(cfg, params, x, enc, *, remat: bool):
    s = x.shape[1]
    x = x + _positions(cfg, torch.arange(s, device=x.device), x.dtype)[None]
    akw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim)

    def unit_fwd(x, p):
        h = attn_mod.attention(
            p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), None, None,
            n_kv_heads=cfg.n_kv_heads, causal=True, **akw)
        x = x + h
        k, v = attn_mod.cross_kv(p["xattn"], enc, **akw)
        x = x + attn_mod.cross_attention(
            p["xattn"], rms_norm(p["lnx"], x, cfg.norm_eps), k, v, **akw)
        x = x + gelu_mlp(p["mlp"], rms_norm(p["ln2"], x, cfg.norm_eps))
        return constrain(x, "act_btd"), _zero(x)

    x, aux = _scan_units(x, params["units"], cfg.n_units, unit_fwd, remat)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    return _lm_head(cfg, params, x), aux


# ---------------------------------------------------------------------- #
# decode (serving)
# ---------------------------------------------------------------------- #
def _kv_cache(shape, dt, dev):
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def has_linear_kv(cfg: ArchConfig) -> bool:
    """Whether decode writes one K/V row per absolute position, so that a
    prompt and its new tokens must fit ``max_len`` and the K/V leaves can
    be paged (the reference's ``engine._has_linear_kv``): the dense, vlm,
    moe and audio families, and the hybrid when it has a shared
    attention block. A sliding window's ring buffer wraps instead; the
    ssm family's state is O(1)."""
    if cfg.sliding_window > 0:
        return False
    return cfg.family in ("dense", "vlm", "moe", "audio") or (
        cfg.family == "hybrid" and cfg.attn_every > 0)


def _require_linear(cfg: ArchConfig, what: str) -> None:
    """``what`` needs the linear cache layout, which the reference gives
    only a config without a window (``init_paged_cache``,
    ``prefill_extend``)."""
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
    one K/V cache per layer of the unit, under "sub{i}"; for audio,
    under "self", beside the dense per-slot cross K/V (n_units, B,
    encoder_seq, H, D) under "cross". The ssm family has no K/V: each
    mLSTM layer's (C, n, m) under "mlstm" and the sLSTM's (h, c, n, m)
    under "slstm", all per slot."""
    if cfg.family == "ssm":
        cache = {"mlstm": xlstm_mod.mlstm_init_cache(
            batch, cfg.d_inner, cfg.n_heads,
            lead=(cfg.n_units, _n_mlstm(cfg)), device=dev)}
        if cfg.slstm_every:
            cache["slstm"] = xlstm_mod.slstm_init_cache(
                batch, cfg.d_model, lead=(cfg.n_units,), device=dev)
        return cache
    if cfg.family == "audio":
        cross = (cfg.n_units, batch, cfg.encoder_seq, cfg.n_heads,
                 cfg.head_dim)
        return {"self": _kv_cache((cfg.n_units,) + kv_shape, dt, dev),
                "cross": _kv_cache(cross, dt, dev)}
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
    N) f32}, "shared": {"k", "v"}}; for moe {"sub{i}": {"k", "v"}}; for
    ssm {"mlstm": {"C", "n", "m"} (n_units, u - 1, B, ...), "slstm":
    {"h", "c", "n", "m"} (n_units, B, d_model)}, all f32; for audio
    {"self": {"k", "v"}, "cross": {"k", "v"}} and "cross_len" 0 (a
    fresh cache holds no encoder rows; ``prefill_cache_whisper`` fills
    them)."""
    dev = resolve_device(device)
    w = cfg.sliding_window
    rows = min(w, max_len) if w else max_len
    kv_shape = (batch, rows, cfg.n_kv_heads, cfg.head_dim)
    cache = {"units": _unit_caches(cfg, batch, kv_shape,
                                   torch_dtype(dtype or cfg.dtype), dev),
             "index": torch.zeros((), dtype=torch.long, device=dev)}
    if cfg.is_encoder_decoder:
        cache["cross_len"] = 0
    return cache


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
    O(max_len); so do the audio family's cross K/V. Linear layout only,
    as in the reference; the ssm family has no K/V to page."""
    _require_linear(cfg, "paged KV")
    if cfg.family == "ssm":
        raise ValueError(f"family {cfg.family!r} has no linear KV cache "
                         f"to page")
    if max_len % page_size:
        raise ValueError(f"max_len {max_len} is not a multiple of "
                         f"page_size {page_size}")
    dev = resolve_device(device)
    kv_shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    cache = {"units": _unit_caches(cfg, batch, kv_shape,
                                   torch_dtype(dtype or cfg.dtype), dev),
             "index": torch.zeros((), dtype=torch.long, device=dev),
             "pages": torch.full((batch, max_len // page_size), -1,
                                 dtype=torch.int32, device=dev)}
    if cfg.is_encoder_decoder:
        cache["cross_len"] = 0
    return cache


@torch.no_grad()
def prefill_cache_whisper(cfg: ArchConfig, params, frames, batch: int,
                          max_len: int, dtype=None) -> Dict:
    """Whisper: run the encoder once over ``frames`` (B, Senc, D) and
    write each decoder unit's cross K/V into a fresh dense cache: the
    first min(Senc, encoder_seq) encoder rows, the rest left zero, and
    that count in ``cross_len``."""
    cache = init_cache(cfg, batch, max_len, dtype,
                       device=params["embed"]["table"].device)
    enc = encode(cfg, params, frames, remat=False)
    cross = cache["units"]["cross"]
    keep = min(enc.shape[1], cross["k"].shape[2])
    for u in range(cfg.n_units):
        p = unit_slice(params["units"], u)["xattn"]
        k, v = attn_mod.cross_kv(p, enc, n_heads=cfg.n_heads,
                                 head_dim=cfg.head_dim)
        cross["k"][u, :, :keep] = k[:, :keep].to(cross["k"].dtype)
        cross["v"][u, :, :keep] = v[:, :keep].to(cross["v"].dtype)
    cache["cross_len"] = keep
    return cache


def _akw(cfg):
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim)


def _serve_units(cfg: ArchConfig, params, cache, x, attn_fn, *,
                 mamba_fn=None, mlstm_fn=None, slstm_fn=None,
                 cross_fn=None):
    """Every unit over the decode cache, in place: ``attn_fn(attention
    params, normed x, K/V cache)`` for each attention block (the hybrid's
    shared block once per unit, with that application's K/V cache; each
    layer of a moe unit with its own; an audio unit's self-attention),
    each block's FFN (MLP, MoE experts or, for audio, the GELU MLP after
    ``cross_fn(cross-attention params, normed x, cross K/V)``), and the
    recurrent layers with their caches: for the hybrid ``mamba_fn``
    (``ssm.mamba2_prefill`` or ``mamba2_decode``) for each Mamba2 layer,
    for ssm ``mlstm_fn`` for each mLSTM layer, then ``slstm_fn``."""
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
        elif cfg.family == "ssm":
            for i in range(_n_mlstm(cfg)):
                lp, lc = unit_slice(p["mlstm"], i), unit_slice(c["mlstm"], i)
                h, _ = mlstm_fn(lp["mlstm"], rms_norm(lp["ln"], x, eps), lc,
                                d_inner=cfg.d_inner, n_heads=cfg.n_heads)
                x = x + h
            if "slstm" in p:
                h, _ = slstm_fn(p["slstm"]["slstm"],
                                rms_norm(p["slstm"]["ln"], x, eps),
                                c["slstm"], n_heads=cfg.n_heads)
                x = x + h
            blocks = []
        elif cfg.family == "audio":
            h, _ = attn_fn(p["attn"], rms_norm(p["ln1"], x, eps), c["self"])
            x = x + h
            x = x + cross_fn(p["xattn"], rms_norm(p["lnx"], x, eps),
                             c["cross"])
            x = x + gelu_mlp(p["mlp"], rms_norm(p["ln2"], x, eps))
            blocks = []
        elif cfg.family == "moe":
            blocks = [(p[f"sub{i}"], c[f"sub{i}"])
                      for i in range(cfg.pattern_unit())]
        else:
            blocks = [(p, c)]
        for bp, bc in blocks:
            h, _ = attn_fn(bp["attn"], rms_norm(bp["ln1"], x, eps), bc)
            x, _ = _ffn_block(bp, cfg, x + h)
    return x


def _embed_tokens(cfg: ArchConfig, params, tokens, positions):
    """Token embeddings, plus sinusoidal positions (``positions``: (S,)
    or (B, 1)) for an encoder-decoder; RoPE configs rotate q and k
    instead."""
    dt = torch_dtype(cfg.dtype)
    x = embed(params["embed"], tokens, dt)
    if cfg.is_encoder_decoder:
        pos = _positions(cfg, positions, dt)
        x = x + (pos[None] if positions.ndim == 1 else pos)
    return constrain(x, "act_btd")


@torch.no_grad()
def prefill(cfg: ArchConfig, params, cache, tokens
            ) -> Tuple[torch.Tensor, Dict]:
    """One-shot prefill of a fresh cache (index 0) from the whole prompt.
    tokens: (B, S) int. Writes the prompt's K/V rows (for a sliding
    window, its last min(S, rows) positions into ring rows t % rows; for
    the hybrid, also each Mamba2 layer's conv window and SSM state after
    the prompt; for ssm, each mLSTM and sLSTM layer's state after the
    prompt, the sLSTM one token a step) in place and returns (logits
    (B, S, V), cache with ``index`` S). An audio cache comes from
    ``prefill_cache_whisper``: the prompt's queries attend its
    ``cross_len`` encoder rows."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    x = _embed_tokens(cfg, params, tokens, positions)
    cos, sin = _rope_tables(cfg, positions)

    def attn(p, xn, kv):
        return attn_mod.attention_prefill(p, xn, cos, sin, kv,
                                          window=cfg.sliding_window,
                                          **_akw(cfg))

    def cross(p, xn, kv):
        n = cache["cross_len"]
        return attn_mod.cross_attention(p, xn, kv["k"][:, :n],
                                        kv["v"][:, :n], n_heads=cfg.n_heads,
                                        head_dim=cfg.head_dim)
    x = _serve_units(cfg, params, cache, x, attn,
                     mamba_fn=ssm_mod.mamba2_prefill,
                     mlstm_fn=xlstm_mod.mlstm_prefill,
                     slstm_fn=xlstm_mod.slstm_decode, cross_fn=cross)
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
            f"or attends an encoder")
    b, s = tokens.shape
    x = constrain(embed(params["embed"], tokens, torch_dtype(cfg.dtype)),
                  "act_btd")
    cos, sin = _rope_tables(
        cfg, torch.arange(start, start + s, device=tokens.device))

    def attn(p, xn, kv):
        return attn_mod.attention_prefill_extend(p, xn, cos, sin, kv,
                                                 start=start, **_akw(cfg))
    x = _serve_units(cfg, params, cache, x, attn)
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
    layer's conv window and SSM state; for ssm, each mLSTM and sLSTM
    layer's state) in place and returns (logits (B, 1, V), cache with
    index + 1). With ``cache["pages"]`` the cache is paged and attention
    takes the paged flash-decode kernel on the card; else the linear
    one, for the ring and an audio unit's cross-attention too."""
    b = tokens.shape[0]
    idx = cache["index"] if index is None else index
    vec = idx.expand(b) if idx.ndim == 0 else idx
    x = _embed_tokens(cfg, params, tokens, vec[:, None])
    cos, sin = _rope_tables(cfg, vec[:, None])
    pages = cache.get("pages")

    def attn(p, xn, kv):
        return attn_mod.attention_decode(p, xn, cos, sin, kv, vec,
                                         pages=pages,
                                         window=cfg.sliding_window,
                                         **_akw(cfg))

    if cfg.is_encoder_decoder:
        lengths = torch.full((b,), cache["cross_len"], dtype=torch.int32,
                             device=tokens.device)

    def cross(p, xn, kv):
        return attn_mod.cross_attention_decode(
            p, xn, kv["k"], kv["v"], lengths, n_heads=cfg.n_heads,
            head_dim=cfg.head_dim)
    x = _serve_units(cfg, params, cache, x, attn,
                     mamba_fn=ssm_mod.mamba2_decode,
                     mlstm_fn=xlstm_mod.mlstm_decode,
                     slstm_fn=xlstm_mod.slstm_decode, cross_fn=cross)
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    new_cache = dict(cache)
    new_cache["index"] = idx + 1
    return _lm_head(cfg, params, x), new_cache
