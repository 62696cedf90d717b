"""The dense family (minicpm-2b as the port runs it: pre-norm blocks of
attention and a SwiGLU MLP, RoPE, an optionally tied head): its model
FLOPs a token and the attention launches of a micro-batch.

Model FLOPs count what the model needs, not what the program launches:
6 x the parameters of every matrix product a token goes through (the
head's too, tied or not; the embedding's lookup is no product), plus the
attention's score and value products, 4 H D (S + 1) / 2 a token and layer
forward and twice that backward. Recompute (remat) is not counted.
"""
from __future__ import annotations

LAYERED = ()        # unit subtrees that stack their layers a second time


def head_dim(run: dict) -> int:
    return run.get("head_dim") or run["d_model"] // run["n_heads"]


def block_params(run: dict) -> int:
    """Matrix parameters of one attention + SwiGLU block."""
    d, hd = run["d_model"], head_dim(run)
    q, kv = run["n_heads"] * hd, run["n_kv_heads"] * hd
    return d * q + 2 * d * kv + q * d + 3 * d * run["d_ff"]


def attention_flops(run: dict, seq: int) -> float:
    """Score and value products of one causal layer, forward and
    backward, a token."""
    return 3 * 4 * run["n_heads"] * head_dim(run) * (seq + 1) / 2


def flops_per_token(run: dict, seq: int) -> float:
    matmul = run["n_layers"] * block_params(run) + run["d_model"] * run["vocab"]
    return 6 * matmul + run["n_layers"] * attention_flops(run, seq)


def attention_launches(run: dict, micro: int, seq: int) -> list:
    """The flash kernels' shapes in a micro-batch: q as (B, H, S, D) with
    the kv heads repeated to H, causal, in the model's dtype."""
    return [{"shape": (micro, run["n_heads"], seq, head_dim(run)),
             "dtype": run["dtype"], "causal": True, "window": 0,
             "layers": run["n_layers"]}]


def ssd_launches(run: dict, micro: int, seq: int) -> list:
    return []
