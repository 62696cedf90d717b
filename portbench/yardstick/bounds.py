"""The least time a kernel launch could take on one H100, from its shapes,
and the chip's published peaks.

``attention_bounds`` and ``ssd_bounds`` are frozen copies of
``chip_smoke.py`` ``_bounds`` (lines 470-497) and ``_ssd_bounds`` (lines
985-1038) at commit f024abf; the peaks are its lines 297-299. Two
changes only: ``pairs`` counts the mask's entries by a closed form where
``_pairs`` (lines 462-467) built the program's ``score_mask``, and the SSD
chunk is the constant the kernels had then (``kernels/ssd.py`` ``CHUNK``,
64), not read from the program.
"""
from __future__ import annotations

# published H100 SXM peaks (NVIDIA data sheet), dense, at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
SSD_CHUNK = 64


def pairs(s: int, causal: bool, window: int, sk=None) -> int:
    """(q, k) score entries the mask keeps among s query rows and sk (s
    unless given) key rows: key j < sk is kept for query i when j <= i
    (causal) and j > i - window (window > 0)."""
    sk = s if sk is None else sk
    total = 0
    for i in range(s):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def attention_bounds(shape, dtype_name, causal, window, sk=None) -> dict:
    """Least milliseconds each kernel could take on an H100: the larger of
    bytes over the memory rate (inputs read once, outputs written once)
    and FLOPs over the peak for the input type. ``shape`` is q's
    (B, H, Sq, D); k and v have ``sk`` rows (Sq unless given)."""
    b, h, s, d = shape
    sk = s if sk is None else sk
    elt = 2 if dtype_name == "bfloat16" else 4
    mat_q, mat_k = b * h * s * d * elt, b * h * sk * d * elt
    row = b * h * s * 4
    n_pairs = b * h * pairs(s, causal, window, sk)
    work = {
        # QK^T and PV: q, k, v in, O and lse out
        "flash_fwd": (2 * mat_q + 2 * mat_k + row, 4 * d * n_pairs),
        # QK^T, dO V^T, dS K: q, k, v, dO, lse, delta in, dQ out
        "flash_bwd_dq": (3 * mat_q + 2 * mat_k + 2 * row, 6 * d * n_pairs),
        # QK^T, dO V^T, P^T dO, dS^T Q: q, k, v, dO, lse, delta in, dK,
        # dV out
        "flash_bwd_dkdv": (2 * mat_q + 4 * mat_k + 2 * row,
                           8 * d * n_pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops
                     else "operations"}
    return out


def ssd_bounds(shape, dtype_name) -> dict:
    """Least milliseconds each SSD wrapper and each of its passes could take
    on an H100, at the kernels' chunk L = 64: the larger of bytes over the
    memory rate (each input read once, each output written once; the
    forward with its per-chunk states, as training runs it; a pass with the
    states or d(states) it reads or writes) and the chunked algorithm's
    products over the f32 peak (the arithmetic is f32 whatever the input
    type). Beside it the TF32 time, and ``bound_3xtf32_ms``, the route the
    kernels take: three TF32 products for each f32 one. The intra-chunk
    (L, L) products count only the L (L + 1) / 2 causal pairs the output
    needs, as ``attention_bounds`` counts causal attention."""
    L = SSD_CHUNK
    b, s, h, p, n = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    x, row, bc = b * s * h * p * elt, b * s * h * elt, b * s * n * elt
    states = b * h * (s // L) * p * n * 4
    grads = 2 * b * s * h * 4 + 2 * b * s * h * n * 4   # ddt, d(dA), dB, dC
    chunks = b * h * (s // L)
    n_pairs = L * (L + 1) // 2
    lpn = 2 * L * p * n                 # flops of one (L,P)^T (L,N) product
    work = {
        # over the pairs: C B^T, m (x dt); C state^T, (x w)^T B
        "ssd_fwd": (2 * x + row + 2 * bc + 4 * h + states,
                    chunks * (2 * n_pairs * (n + p) + 2 * lpn)),
        # the prefill's form: no per-chunk states kept, an initial state
        # read and the final state written
        "ssd_prefill": (2 * x + row + 2 * bc + 4 * h + 2 * b * h * p * n * 4,
                        chunks * (2 * n_pairs * (n + p) + 2 * lpn)),
        # over the pairs: scores, dscores^T C, dscores B (N), dxdt, dm
        # (P); dxw, y_inter, g, dyec s0, dyec^T C; dx, ddt, d(dA), dB and
        # dC partials out
        "ssd_bwd": (3 * x + row + 2 * bc + 4 * h + states + grads,
                    chunks * (2 * n_pairs * (3 * n + 2 * p) + 5 * lpn)),
        # the passes: (x w)^T B; then the rest of the forward
        "fwd_state": (x + row + bc + 4 * h + states, chunks * lpn),
        "fwd_chunk": (2 * x + row + 2 * bc + 4 * h + states,
                      chunks * (2 * n_pairs * (n + p) + lpn)),
        # (dy e)^T C; then the rest of the backward, given d(states)
        "bwd_state": (x + row + bc + 4 * h + states, chunks * lpn),
        "bwd_chunk": (3 * x + row + 2 * bc + 4 * h + 2 * states + grads,
                      chunks * (2 * n_pairs * (3 * n + 2 * p) + 4 * lpn)),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops
                     else "operations",
                     "bound_tf32_ms": max(t_bytes, flops / PEAK_TF32 * 1e3),
                     "bound_3xtf32_ms": max(t_bytes,
                                            3 * flops / PEAK_TF32 * 1e3),
                     "bound_bytes": nbytes, "bound_flops": flops}
    return out
