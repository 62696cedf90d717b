"""Plain reference of the dense family (and, with M-RoPE and a vision
prefix, the vlm family): one row's loss, f32.

Each of the ``n_layers`` blocks is x + attention(rms_norm(x)) followed by
x + SwiGLU(rms_norm(x)); then a final norm and the head, the embedding
table transposed when tied. Parameters are looked up by the flat keys of
the weights the benchmark made: the blocks' leaves as ``key[u]``, one a
block. The blocks are recomputed in the backward (``checkpoint``) so that
a full-width model fits beside its f32 optimizer state; that changes no
value.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .common import (attention, mrope_angles, rms_norm, rope_angles, swiglu,
                     token_loss, mm)

BLOCK = ("ln1/scale", "attn/wq/w", "attn/wk/w", "attn/wv/w", "attn/wo/w",
         "ln2/scale", "mlp/gate/w", "mlp/up/w", "mlp/down/w")


def block(x, ang, run, prec, ln1, wq, wk, wv, wo, ln2, gate, up, down):
    eps = run["norm_eps"]
    x = x + attention(rms_norm(x, ln1, eps), wq, wk, wv, wo, ang,
                      n_heads=run["n_heads"], n_kv_heads=run["n_kv_heads"],
                      head_dim=run["head_dim"], prec=prec)
    return x + swiglu(rms_norm(x, ln2, eps), gate, up, down, prec)


def angles(run, seq, device):
    if not run.get("rope", True):
        return None
    if run.get("mrope_sections"):
        return mrope_angles(seq, run["head_dim"], run["rope_theta"],
                            run["mrope_sections"], run["vision_tokens"],
                            device)
    return rope_angles(torch.arange(seq, device=device), run["head_dim"],
                       run["rope_theta"])


def head(x, P, run, prec):
    x = rms_norm(x, P["ln_f/scale"], run["norm_eps"])
    if run["tie_embeddings"]:
        return mm(x, P["embed/table"].t(), prec)
    return mm(x, P["lm_head/w"], prec)


def embed(P, run, row):
    x = P["embed/table"][row["tokens"]]
    if "vision_embeds" in row:
        vis = row["vision_embeds"].float()
        x = torch.cat([vis, x[vis.shape[0]:]])
    return x


def row_loss(P, run, row, prec):
    """One row's loss: row = {tokens (S,), labels (S,)[, vision_embeds]}."""
    seq = row["tokens"].shape[0]
    ang = angles(run, seq, row["tokens"].device)
    x = embed(P, run, row)
    for u in range(run["n_layers"]):
        ws = [P[f"units/{k}[{u}]"] for k in BLOCK]
        x = checkpoint(block, x, ang, run, prec, *ws, use_reentrant=False)
    return token_loss(head(x, P, run, prec), row["labels"])
