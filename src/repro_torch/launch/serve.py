"""Serving entry points (the reference's ``launch/serve.py``).

Prefill fills the KV cache with one full-sequence call (``prefill``);
generation runs the token loop with every token kept on the device, so an
N-token generation makes one copy to the host at its end
(``engine="scan"``, the reference's fused ``lax.scan``). The per-token
paths are kept as baselines: ``prefill_mode="per_token"`` prefills with
one ``decode_step`` per prompt token, and ``engine="eager"`` copies each
token to the host as it is made. Capturing the loop in a CUDA graph is
later work.

Sampling takes an explicit ``torch.Generator`` on the logits' device;
greedy decoding is what is held against the reference. An
encoder-decoder (whisper-tiny) takes the stubbed audio frontend's
frames: the encoder runs once and fills each layer's cross K/V
(``prefill_cache_whisper``) before the prompt's prefill.

    python -m repro_torch.launch.serve --arch xlstm-1.3b --reduced \\
        --device cpu --tokens 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import (decode_step, init_cache, init_params,
                                prefill, prefill_extend)
from repro_torch.models.model import has_linear_kv, prefill_cache_whisper


def _device(params) -> torch.device:
    return params["embed"]["table"].device


def prefill_one_shot(cfg, params, tokens, cache):
    """One call fills the whole cache. Returns (last-position logits
    (B, 1, V), cache)."""
    logits, cache = prefill(cfg, params, cache, tokens)
    return logits[:, -1:], cache


def prefill_per_token(cfg, params, tokens, cache):
    """Teacher-forced prefill: one ``decode_step`` per prompt token (the
    baseline). Returns (last-position logits (B, 1, V), cache)."""
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1])
    return logits[:, -1:], cache


def prefill_extend_cached(cfg, params, cache, tokens, *, start: int):
    """Suffix prefill (prefix-shared serving): compute rows
    ``[start, start + S)`` into a cache whose prefix rows are filled.
    Returns (logits (B, S, V), cache)."""
    return prefill_extend(cfg, params, cache, tokens, start=start)


def _next_token(logits, greedy: bool, generator):
    """(B, 1) int64 next token from the last position's logits."""
    if greedy:
        return torch.argmax(logits[:, -1:], dim=-1)
    probs = torch.softmax(logits[:, -1].float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def _make_scan_generate(cfg, steps: int, greedy: bool):
    """The device-side loop: each step emits the carried token and draws
    the next from its logits, with no host sync. Returns a function of
    (params, cache, tok, generator) -> (tokens (B, steps) on the device,
    cache, next token), so segmented callers (``launch/engine.py``) can
    continue the carry."""
    def run(params, cache, tok, generator=None):
        out = []
        for _ in range(steps):
            out.append(tok)
            logits, cache = decode_step(cfg, params, cache, tok)
            tok = _next_token(logits, greedy, generator)
        return torch.cat(out, dim=1), cache, tok
    return run


@torch.no_grad()
def generate(cfg, params, prompt, *, max_new_tokens: int = 16,
             max_len: int = 256, greedy: bool = True, generator=None,
             engine: str = "scan", prefill_mode: str = "one_shot",
             frames=None) -> torch.Tensor:
    """Generate ``max_new_tokens`` tokens for a (B, S) prompt batch on the
    parameters' device. Returns the tokens, (B, max_new_tokens) int64 on
    the CPU.

    A linear cache holds one row per prompt and generated token, so
    S + max_new_tokens must not exceed ``max_len``: the port raises
    ``ValueError`` where the reference's ``dynamic_update_slice`` would
    clamp the write silently. A sliding window's ring buffer of
    min(window, max_len) rows wraps instead, and takes any length. The
    first token is the prefill's argmax, as in the reference; later ones
    are sampled from ``generator`` unless ``greedy``. A MoE layer's
    einsum and scatter dispatches route a prompt in groups of
    min(256, S) tokens, so S must be a multiple of its group. An
    encoder-decoder needs ``frames`` (B, Senc, d_model)."""
    dev = _device(params)
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, plen = prompt.shape
    if has_linear_kv(cfg) and plen + max_new_tokens > max_len:
        raise ValueError(f"prompt of {plen} + {max_new_tokens} new tokens "
                         f"does not fit max_len {max_len}")
    if generator is None and not greedy:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: "
                             f"generate needs frames")
        cache = prefill_cache_whisper(
            cfg, params, torch.as_tensor(frames, device=dev), b, max_len)
    else:
        cache = init_cache(cfg, b, max_len, device=dev)
    if prefill_mode == "one_shot":
        logits, cache = prefill_one_shot(cfg, params, prompt, cache)
    elif prefill_mode == "per_token":
        logits, cache = prefill_per_token(cfg, params, prompt, cache)
    else:
        raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
    tok = torch.argmax(logits[:, -1:], dim=-1)

    if engine == "scan":
        run = _make_scan_generate(cfg, max_new_tokens, greedy)
        return run(params, cache, tok, generator)[0].cpu()
    if engine == "eager":
        out = []
        for _ in range(max_new_tokens):
            out.append(tok.cpu())
            logits, cache = decode_step(cfg, params, cache, tok)
            tok = _next_token(logits, greedy, generator)
        return torch.cat(out, dim=1)
    raise ValueError(f"unknown engine {engine!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="xlstm-1.3b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--engine", default="scan", choices=("scan", "eager"))
    ap.add_argument("--prefill", default="one_shot",
                    choices=("one_shot", "per_token"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg, 0, device=args.device)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)))
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.as_tensor(rng.standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model)) * 0.02,
            dtype=torch.float32)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, max_new_tokens=args.tokens,
                    engine=args.engine, prefill_mode=args.prefill,
                    frames=frames)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={_device(params)} engine={args.engine} "
          f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")
    print(toks[0].tolist())
    return toks


if __name__ == "__main__":
    main()
