#!/usr/bin/env python3
"""This tree's flash-attention and flash-decode kernels against another
build of them, bit for bit, on one NVIDIA H100.

    python3 flash_bitwise.py OTHER/src/repro_torch/kernels/csrc/flash_attention.cu \
        [OTHER/src/repro_torch/kernels/csrc/flash_decode.cu]

Builds each ``OTHER`` library named by its entry source
(flash_attention.cu, flash_decode.cu or both) from that source and the
ones beside it that share its name (a library split over several
sources, as ``flash_decode.cuh`` and ``flash_decode_<t>_<d>.cu`` are, is
built whole; an older tree's single file alone), and this tree's from
its own sources (``build.LIBRARIES``), one ``nvcc`` per source, all
started together; then runs both on the same inputs. Attention: the
forward, dQ and dK/dV of every square case of ``CASES`` (f32 and bf16,
head_dim 64, 112, 128 and 160, causal, non-causal and windowed, ragged
S, and minicpm-2b's and stablelm-12b's layer shapes); every output, O,
lse, dQ, dK and dV, must be bitwise equal. ``OTHER``'s backward entries
may take one sequence length (the form before Sk != Sq) or two; where
``OTHER`` runs the bf16 dK/dV at D = 160 as two passes (dV, then dK),
this tree's one pass must give the same bits.
Decode: the linear and the paged kernel on every case of
``DECODE_CASES`` (f32 and bf16, head_dim 64 to 160, MHA and GQA, an
empty slot, ragged lengths, the serving phases' shapes) at this tree's
default split of 256; ``OTHER``'s entries may or may not take a split
(the form before the split was an argument had it fixed at 256); both
outputs must be bitwise equal. Its use: a change that must leave the
default path alone (the rectangular Sq != Sk backward, the split as an
argument, the one-pass dK/dV at D = 160, a library split over several
sources) is held against the build before it. Prints one JSON line per
case, then the card's name and power limit; exits 1 if any output
differs. Imports nothing of JAX or of the JAX package.
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
# (B, H, H_kv, S, D), dtype: decode over S cache rows a slot (page size 16)
DECODE_CASES = ([((4, 8, h_kv, 1300, d), dt) for dt in ("bfloat16", "float32")
                 for d in (64, 112, 128, 160) for h_kv in (8, 2)]
                + [((8, 36, 36, 4096, 64), "bfloat16"),
                   ((8, 32, 32, 4096, 112), "bfloat16"),
                   ((8, 12, 2, 4096, 128), "bfloat16"),
                   ((8, 32, 8, 4096, 160), "bfloat16")])


def _takes(text: str, entry: str, param: str) -> bool:
    """Whether C entry ``entry`` of ``text`` declares ``param``."""
    return bool(re.search(entry + r"\([^)]*\b" + param + r"\b", text))


def other_sources(path: str) -> list:
    """The sources of the library whose entry source is ``path``: it, and
    the headers and sources beside it whose names start with its stem."""
    import glob
    stem = path[:-len(".cu")]
    return [path] + sorted(p for p in glob.glob(stem + "*.cu*")
                           if p != path and p.endswith((".cu", ".cuh")))


def other_library(path: str):
    """``path``'s library built and bound; its backward entries' argtypes
    follow their C declaration (one ``int s`` or ``int sq, int sk``)."""
    from repro_torch.kernels import build
    with open(path) as f:
        text = f.read()
    two = re.search(r"repro_flash_bwd_dq\([^)]*int sq, int sk", text)
    n = 7 if two else 6
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.Library("flash_attention_other", other_sources(path), {
        "repro_flash_fwd": [p] * 5 + [i] * 8 + [fl, p],
        "repro_flash_bwd_dq": [p] * 7 + [i] * n + [fl, p],
        "repro_flash_bwd_dkdv": [p] * 8 + [i] * n + [fl, p]}
    ), bool(two)


def other_decode_library(path: str):
    """``path``'s library (a flash_decode.cu and its split sources, if
    any) built and bound; its entries take a split or not, as their C
    declaration says."""
    from repro_torch.kernels import build
    with open(path) as f:
        text = f.read()
    split = _takes(text, "repro_flash_decode", "split")
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return build.Library("flash_decode_other", other_sources(path), {
        "repro_flash_decode_workspace": [i] * (4 + split),
        "repro_flash_decode": [p] * 6 + [i] * (6 + split) + [fl, p],
        "repro_flash_decode_paged": [p] * 7 + [i] * (7 + split) + [fl, p]}
    ), split


def run_other_decode(lib, split, q, k, v, lengths, kp, vp, pages):
    """Linear and paged decode through ``lib``'s C entries at split 256
    (where it takes one)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.flash_attention import _DTYPES
    st = torch.cuda.current_stream().cuda_stream
    b, _, h, d = q.shape
    h_kv, dt = k.shape[2], _DTYPES[q.dtype]
    sp = (fd.SPLIT,) if split else ()
    outs, rc = [], []
    for paged, cap in ((False, k.shape[1]),
                       (True, pages.shape[1] * kp.shape[1])):
        n = lib.repro_flash_decode_workspace(b, h, d, cap, *sp)
        work = torch.empty(n, dtype=torch.float32, device=q.device)
        o = torch.empty_like(q)
        if paged:
            rc.append(lib.repro_flash_decode_paged(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pages.data_ptr(),
                lengths.data_ptr(), o.data_ptr(), work.data_ptr(), b, h,
                h_kv, kp.shape[1], pages.shape[1], d, dt, *sp, d ** -0.5,
                st))
        else:
            rc.append(lib.repro_flash_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                o.data_ptr(), work.data_ptr(), b, h, h_kv, k.shape[1], d, dt,
                *sp, d ** -0.5, st))
        outs.append(o)
    if any(rc):
        raise RuntimeError(f"the other decode build failed to launch: {rc}")
    return outs


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


def attention_cases(lib, two) -> list:
    """Every case of ``CASES`` through ``lib`` and this tree; the cases
    that differ."""
    import torch
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
    return differ


def decode_cases(lib, split) -> list:
    """Every case of ``DECODE_CASES`` through ``lib`` and this tree's
    wrappers at split 256; the cases that differ."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_decode as fd
    differ = []
    for n, ((b, h, h_kv, s, d), dname) in enumerate(DECODE_CASES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(n)
        rng = np.random.default_rng(n)
        lens = [0, s] + rng.integers(1, s + 1, b - 2).tolist()
        lengths = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
        q, k, v, (kp, vp), pages = cs._decode_inputs(
            gen, b, h, h_kv, s, d, getattr(torch, dname), lengths, 16)
        a = run_other_decode(lib.lib, split, q, k, v, lengths, kp, vp,
                             pages)
        this = (fd.flash_decode(q, k, v, lengths, split=fd.SPLIT),
                fd.flash_decode_paged(q, kp, vp, pages, lengths,
                                      split=fd.SPLIT))
        torch.cuda.synchronize()
        same = {name: bool(torch.equal(x, y)) for name, x, y in
                zip(("linear", "paged"), a, this)}
        print(json.dumps({"decode": [b, h, h_kv, s, d], "dtype": dname,
                          "lengths": lens, "split": fd.SPLIT,
                          "bitwise_equal": same}), flush=True)
        if not all(same.values()):
            differ.append(((b, h, h_kv, s, d), dname))
    print(json.dumps({"decode_cases": len(DECODE_CASES),
                      "differ": len(differ), "other_takes_split": split}))
    return differ


# basename of an OTHER source -> (this tree's library, the binder, the runner)
SOURCES = {"flash_attention.cu": ("flash_attention", other_library,
                                  attention_cases),
           "flash_decode.cu": ("flash_decode", other_decode_library,
                               decode_cases)}


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("flash_bitwise: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    names = [os.path.basename(a) for a in argv]
    if (not argv or len(set(names)) != len(names)
            or any(n not in SOURCES or not os.path.isfile(a)
                   for n, a in zip(names, argv))):
        print("usage: python3 flash_bitwise.py OTHER/flash_attention.cu "
              "[OTHER/flash_decode.cu]", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    other = {}

    def bind(name, path):
        other[name] = SOURCES[name][1](os.path.abspath(path))

    threads = [threading.Thread(target=bind, args=(n, a))
               for n, a in zip(names, argv)]
    threads += [threading.Thread(target=build.library,
                                 args=(SOURCES[n][0],)) for n in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if set(other) != set(names):
        return 1                     # a thread printed its build error
    differ = []
    for name in names:
        lib, form = other[name]
        differ += SOURCES[name][2](lib, form)
    print(cs.nvidia_smi())
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
