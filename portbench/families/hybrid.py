"""The hybrid family (zamba2-7b as the port runs it): units of
``attn_every`` Mamba2 layers, each unit followed by one application of a
shared attention + SwiGLU block; an untied head.

Model FLOPs a token: 6 x the matrix parameters a token goes through (each
Mamba2 layer's in and out projections, the shared block once for each
application, the head), the shared block's attention products as the
dense family counts them, and the SSD's products of the chunked scan at
the kernels' chunk L = 64, counted as ``yardstick.bounds.ssd_bounds``
counts them but with C B^T once a chunk (it is shared by the heads):
forward L (L + 1) / 2 pairs x 2 N, and per head the pairs x 2 P and the
two (L, P, N) products of the states, 2 x 2 L P N; backward twice the
forward. The depthwise conv (2 k C a token) is elementwise work and not
counted."""
from __future__ import annotations

from ..yardstick.bounds import SSD_CHUNK
from . import dense

LAYERED = ("units/mamba/",)


def d_inner(run: dict) -> int:
    return run["ssm_expand"] * run["d_model"]


def mamba_params(run: dict) -> int:
    d, di, n, h = run["d_model"], d_inner(run), run["ssm_state"], \
        run["ssm_heads"]
    return d * (2 * di + 2 * n + h) + di * d


def ssd_flops(run: dict) -> float:
    """The SSD's products of one layer, forward and backward, a token."""
    L, n, h = SSD_CHUNK, run["ssm_state"], run["ssm_heads"]
    p = d_inner(run) // h
    n_pairs = L * (L + 1) // 2
    fwd = n_pairs * 2 * n + h * (n_pairs * 2 * p + 2 * 2 * L * p * n)
    return 3 * fwd / L


def applications(run: dict) -> int:
    return run["n_layers"] // run["attn_every"] if run["attn_every"] else 0


def flops_per_token(run: dict, seq: int) -> float:
    apps = applications(run)
    matmul = (run["n_layers"] * mamba_params(run)
              + apps * dense.block_params(run) + run["d_model"] * run["vocab"])
    return (6 * matmul + run["n_layers"] * ssd_flops(run)
            + apps * dense.attention_flops(run, seq))


def attention_launches(run: dict, micro: int, seq: int) -> list:
    apps = applications(run)
    if not apps:
        return []
    return [{"shape": (micro, run["n_heads"], seq, dense.head_dim(run)),
             "dtype": run["dtype"], "causal": True, "window": 0,
             "layers": apps}]


def ssd_launches(run: dict, micro: int, seq: int) -> list:
    """The SSD wrapper's operands, (B, S, H, P, N), in f32: the port
    casts x, dt, B and C to f32 before the scan."""
    h = run["ssm_heads"]
    return [{"shape": (micro, seq, h, d_inner(run) // h, run["ssm_state"]),
             "dtype": "float32", "layers": run["n_layers"]}]
