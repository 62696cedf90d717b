"""AdamW and the WSD / cosine schedules (the reference's
``train/optimizer.py``).

``adamw_update`` works **in place**: it overwrites the parameter and
moment tensors under ``torch.no_grad()``, which takes the place of the
reference's buffer donation (``make_jit_train_step``) and keeps one copy
of the optimizer state on the card. The arithmetic is the reference's, in
the same f32 order, with the cast back to each tensor's dtype; it runs in
chunks so the f32 temporaries stay small next to a full-width model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.sharding.hooks import is_dtensor
from repro_torch.tree import flatten, zeros_like_tree

# elements per chunk of the in-place update (64 MiB of f32 temporaries)
_CHUNK = 1 << 24


@dataclass
class OptState:
    step: int
    m: Any
    v: Any


def adamw_init(params, moment_dtype=torch.float32) -> OptState:
    return OptState(step=0, m=zeros_like_tree(params, moment_dtype),
                    v=zeros_like_tree(params, moment_dtype))


def _chunks(t: torch.Tensor):
    """``t`` flat in chunks of ``_CHUNK`` elements; a DTensor's local
    block (an elementwise update needs no other rank's)."""
    if is_dtensor(t):
        t = t.to_local()
    return t.view(-1).split(_CHUNK)


@torch.no_grad()
def adamw_update(grads, opt: OptState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """Updates ``params`` and ``opt`` in place and returns them.
    ``lr`` may be a scalar or a schedule(step) callable. DTensor leaves
    (a gradient at its parameter's placements, the moments too) are
    updated on each rank's local block."""
    step = opt.step + 1
    lr_t = float(lr(step)) if callable(lr) else float(lr)
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    fp, fg = flatten(params), flatten(grads)
    fm, fv = flatten(opt.m), flatten(opt.v)
    for key, p in fp.items():
        if is_dtensor(p) and fg[key].placements != p.placements:
            raise ValueError(f"adamw_update: gradient of {key} at "
                             f"{fg[key].placements}, parameter at "
                             f"{p.placements}")
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(fg[key]),
                                  _chunks(fm[key]), _chunks(fv[key])):
            g = gc.float()
            m_new = b1 * mc.float() + (1 - b1) * g
            v_new = b2 * vc.float() + (1 - b2) * g * g
            mhat = m_new / c1
            vhat = v_new / c2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * \
                pc.float()
            pc.copy_(pc.float() - lr_t * delta)
            mc.copy_(m_new)
            vc.copy_(v_new)
    opt.step = step
    return params, opt


def wsd_schedule(*, peak_lr: float, warmup_steps: int, stable_steps: int,
                 decay_steps: int, floor: float = 0.0) -> Callable:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup,
    long constant plateau, linear decay; f32 arithmetic."""
    f = np.float32

    def lr(step) -> float:
        step = f(step)
        if step < warmup_steps:
            return float(f(peak_lr) * step / f(max(warmup_steps, 1)))
        if step < warmup_steps + stable_steps:
            return float(f(peak_lr))
        frac = (step - f(warmup_steps) - f(stable_steps)) / f(
            max(decay_steps, 1))
        return float(f(peak_lr) * max(f(1.0) - frac, f(0.0)) + f(floor))
    return lr


def cosine_schedule(*, peak_lr: float, warmup_steps: int, total_steps: int,
                    floor_frac: float = 0.1) -> Callable:
    f = np.float32

    def lr(step) -> float:
        step = f(step)
        if step < warmup_steps:
            return float(f(peak_lr) * step / f(max(warmup_steps, 1)))
        prog = np.clip((step - f(warmup_steps))
                       / f(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
        return float(f(peak_lr) * (f(floor_frac) + f(1 - floor_frac) * f(0.5)
                                   * (f(1) + np.cos(f(np.pi) * f(prog)))))
    return lr
