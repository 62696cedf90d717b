#!/usr/bin/env python3
"""This tree's flash-attention kernels against another build of them, bit
for bit, at Sq == Sk, on one NVIDIA H100.

    python3 flash_bitwise.py OTHER/src/repro_torch/kernels/csrc/flash_attention.cu

Builds ``OTHER``'s flash_attention.cu beside this tree's (one ``nvcc``
each, started together) and runs both on the same inputs: the forward,
dQ and dK/dV of every square case of ``CASES`` (f32 and bf16, head_dim
64, 112, 128 and 160, causal, non-causal and windowed, ragged S, and
minicpm-2b's and stablelm-12b's layer shapes). Every output, O, lse,
dQ, dK and dV, must be bitwise equal. Its use: a change to the kernels'
indexing that must leave the square case alone (the rectangular Sq !=
Sk backward) is held against the build before it. ``OTHER``'s backward
entries may take one sequence length (the form before Sk != Sq) or two.
Prints one JSON line per case, then the card's name and power limit;
exits 1 if any output differs. Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import sys
import threading

ROOT = os.path.dirname(os.path.abspath(__file__))

# (B, H, S, D), dtype, causal, window
CASES = ([((1, 4, 1000, d), dt, c, w) for dt in ("bfloat16", "float32")
          for d in (64, 112, 128, 160)
          for c, w in ((True, 0), (False, 0), (True, 200))]
         + [((1, 36, 2048, 64), "bfloat16", True, 0),
            ((1, 32, 2048, 160), "bfloat16", True, 0)])


def other_library(path: str):
    """``path`` built and bound; its backward entries' argtypes follow
    their C declaration (one ``int s`` or ``int sq, int sk``)."""
    from repro_torch.kernels import build
    with open(path) as f:
        text = f.read()
    two = re.search(r"repro_flash_bwd_dq\([^)]*int sq, int sk", text)
    n = 7 if two else 6
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.Library("flash_attention_other", [path], {
        "repro_flash_fwd": [p] * 5 + [i] * 8 + [fl, p],
        "repro_flash_bwd_dq": [p] * 7 + [i] * n + [fl, p],
        "repro_flash_bwd_dkdv": [p] * 8 + [i] * n + [fl, p]}), bool(two)


def run_other(lib, two, q, k, v, do, causal, window):
    """Forward, delta, dQ and dK/dV through ``lib``'s C entries."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    st = torch.cuda.current_stream().cuda_stream
    b, h, s, d = q.shape
    dt = fa._DTYPES[q.dtype]
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    rc = [lib.repro_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), lse.data_ptr(), b * h, s, s, 0,
                              d, dt, causal, window, d ** -0.5, st)]
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rows = (s, s) if two else (s,)
    common = (b * h, *rows, d, dt, causal, window, d ** -0.5, st)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    rc.append(lib.repro_flash_bwd_dq(*ptrs, dq.data_ptr(), *common))
    rc.append(lib.repro_flash_bwd_dkdv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                       *common))
    if any(rc):
        raise RuntimeError(f"the other build failed to launch: {rc}")
    return o, lse, dq, dk, dv


def run_this(q, k, v, do, causal, window):
    from repro_torch.kernels import flash_attention as fa
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    return o, lse, dq, dk, dv


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("flash_bitwise: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if len(argv) != 1 or not os.path.isfile(argv[0]):
        print("usage: python3 flash_bitwise.py OTHER/flash_attention.cu",
              file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    other = {}
    th = threading.Thread(target=lambda: other.update(
        lib=other_library(os.path.abspath(argv[0]))))
    th.start()
    build.library("flash_attention")
    th.join()
    if "lib" not in other:
        return 1                     # the thread printed its build error
    lib, two = other["lib"]
    gen = torch.Generator(device="cuda")
    differ = []
    for shape, dname, causal, window in CASES:
        gen.manual_seed(1)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(getattr(torch, dname)) for _ in range(4))
        a = run_other(lib.lib, two, q, k, v, do, int(causal), window)
        b = run_this(q, k, v, do, causal, window)
        torch.cuda.synchronize()
        same = {n: bool(torch.equal(x, y))
                for n, x, y in zip(("o", "lse", "dq", "dk", "dv"), a, b)}
        print(json.dumps({"shape": list(shape), "dtype": dname,
                          "causal": causal, "window": window,
                          "bitwise_equal": same}), flush=True)
        if not all(same.values()):
            differ.append((shape, dname, causal, window))
    print(json.dumps({"cases": len(CASES), "differ": len(differ),
                      "other_backward_takes_sq_and_sk": two}))
    print(cs.nvidia_smi())
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
