#!/usr/bin/env python3
"""Where the SSD kernels' time goes, on one NVIDIA H100.

    python3 ssd_variants.py

Builds variants of ``src/repro_torch/kernels/csrc/ssd.cu`` (each a text
substitution on the source, compiled for f32 at P = N = 64 only) and times
each of the four passes, and each wrapper call, at one zamba2 layer's shape
(1, 2048, 112, 64, 64) with ``chip_smoke.cuda_time``. A variant is a
measurement, not a design: several compute wrong results on purpose (a
pass without its loads or without its products). Each variant's outputs
are held against the passes' plain versions and the largest row error is
printed beside its times; the variants marked exact must stay within
``chip_smoke.SSD_TOL``. Prints one JSON line per variant, then the card's
name and power limit. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPE = (1, 2048, 112, 64, 64)

_STATE_LOADS = """\
    load_tile<T, L, SLAB, Pad<XS>, NTS>(sU + stage * L * XS, u + (row0 * H + h) * P + p0,
                                        (size_t)H * P);
    load_tile<T, L, N, Swz<N>, NTS>(sV + stage * L * N, v + row0 * N, N);"""
_MMA3 = """\
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);"""
_BWD_LOADS = """\
  load_tile<T, L, P, Swz<P>, NTC>(sX, x + (ck.row0 * H + ck.h) * P, (size_t)H * P);
  load_tile<T, L, P, Swz<P>, NTC>(sDy, dy + (ck.row0 * H + ck.h) * P, (size_t)H * P);
  load_tile<float, P, N, Swz<N>, NTC>(sS, states + ck.state(H, P, N), N);"""
_DS1_LOAD = "for (int i = 0; i < PN4; ++i) ds1[i] = src[i * NTC + tid];"
_STATE_FRAG = ("      const FragA fa = frag_a([&](int r, int k) { return "
               "U[Pad<XS>::at(k, r)] * sWt[k]; }, 0, k0);")
_STATE_OPERANDS = """\
    const float* U = sU + stage * L * XS;
    const float* V = sV + stage * L * N;
"""
_CHUNK_START = "  const Chunk ck(S, H);\n  const Warp W;\n"

# name: (exact, [(old, new), ...])
VARIANTS = {
    "as is": (True, []),
    # the state passes load x or dy and B or C for the first and last chunk
    # only
    "state passes without reloads": (False, [(
        _STATE_LOADS,
        "    if (c == 0 || c == nc - 1) {\n" + _STATE_LOADS + "\n    }")]),
    "no products": (False, [(_MMA3, "")]),
    "one tf32 pass": (False, [(_MMA3, "  mma_tf32(d, a.hi, b.hi);")]),
    "backward chunk pass without loads": (False, [
        (_BWD_LOADS, "  if (ck.c < 0) {\n" + _BWD_LOADS + "\n  }"),
        (_DS1_LOAD, "for (int i = 0; i < PN4; ++i) ds1[i] = "
                    "make_float4(0.f, 0.f, 0.f, (float)(size_t)src);")]),
    # the state pass's A operand (u wt)^T split once into shared memory as
    # (hi, lo) pairs, one more barrier a chunk, instead of by every warp
    "state passes split A once": (True, [
        ("  float* sWt = sV + 2 * L * N;       // [L]         the row weights\n",
         "  float* sWt = sV + 2 * L * N;\n"
         "  float2* sA = reinterpret_cast<float2*>(sWt + L);\n"),
        (_STATE_OPERANDS, _STATE_OPERANDS + """\
    for (int e = threadIdx.x; e < L * SLAB; e += NTS) {
      const int l = e / SLAB, p = e % SLAB;
      uint32_t hi, lo;
      split(U[Pad<XS>::at(l, p)] * sWt[l], hi, lo);
      sA[l * SLAB + (p ^ ((l & 3) << 2))] =
          make_float2(__uint_as_float(hi), __uint_as_float(lo));
    }
    __syncthreads();
"""),
        (_STATE_FRAG, """\
      FragA fa;
      for (int q = 0; q < 4; ++q) {
        const int r = g + 8 * (q & 1), k = k0 + t + 4 * (q >> 1);
        const float2 hl = sA[k * SLAB + (r ^ ((k & 3) << 2))];
        fa.hi[q] = __float_as_uint(hl.x);
        fa.lo[q] = __float_as_uint(hl.y);
      }"""),
        ("(size_t)2 * L * (SLAB + 8) + 2 * L * n + L);",
         "(size_t)2 * L * (SLAB + 8) + 2 * L * n + L + 2 * L * SLAB);")]),
    "state passes with 8 warps": (True, [
        ("constexpr int NWS = 4;", "constexpr int NWS = 8;")]),
    "k loops fully unrolled": (True, [("#pragma unroll 2\n",
                                       "#pragma unroll\n")]),
    "k loops unrolled 4 times": (True, [("#pragma unroll 2\n",
                                         "#pragma unroll 4\n")]),
    "lo not rounded": (True, [(
        "lo = tf32_rna(__float_as_uint(v - __uint_as_float(hi)));",
        "lo = __float_as_uint(v - __uint_as_float(hi));")]),
    # the second block resident on each SM starts 8 us late: tests whether
    # the two blocks of an SM load and compute in lockstep
    "second block on each SM 8 us late": (True, [(
        _CHUNK_START,
        "  if (blockIdx.x >= 132 && blockIdx.x < 264) __nanosleep(8000);\n"
        + _CHUNK_START)]),
}


def variant_source(text: str, subs) -> str:
    """The source with each substitution made; raises if one finds
    nothing, so a stale variant fails instead of timing the original."""
    keep = "if (dtype == 0 && p == 64 && n == 64)"
    text = "\n".join(ln for ln in text.split("\n")
                     if not ln.lstrip().startswith("if (dtype ==")
                     or keep in ln)
    for old, new in subs:
        if old not in text:
            raise ValueError(f"substitution not found: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def measure(name, exact, library, inputs):
    """Times and largest row errors of each pass and wrapper."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ref, ssd
    build._LOADED["ssd"] = library
    x, dt, a, bm, cm, dy = inputs
    L = ssd.CHUNK
    st_r = ref.ssd_fwd_state_ref(x, dt, a, bm, chunk=L)
    ds_r = ref.ssd_bwd_state_ref(dt, a, cm, dy, chunk=L)
    fns = {
        "fwd_state": lambda: ssd.fwd_state(x, dt, a, bm),
        "fwd_chunk": lambda: ssd.fwd_chunk(x, dt, a, bm, cm, st_r),
        "bwd_state": lambda: ssd.bwd_state(dt, a, cm, dy),
        "bwd_chunk": lambda: ssd.bwd_chunk(x, dt, a, bm, cm, st_r, ds_r, dy),
        "ssd_fwd": lambda: ssd.ssd_fwd(x, dt, a, bm, cm, return_states=True),
        "ssd_bwd": lambda: ssd.ssd_bwd(x, dt, a, bm, cm, st_r, dy),
    }
    plain = {
        "fwd_state": st_r,
        "fwd_chunk": ref.ssd_fwd_chunk_ref(x, dt, a, bm, cm, st_r, chunk=L),
        "bwd_state": ds_r,
        "bwd_chunk": ref.ssd_bwd_chunk_ref(x, dt, a, bm, cm, st_r, ds_r, dy,
                                           chunk=L),
    }
    errs = {}
    for key, want in plain.items():
        got = fns[key]()
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        errs[key] = max(cs._row_err(g, w) for g, w in pairs)
    ms = {key: cs.cuda_time(fn, iters=20) for key, fn in fns.items()}
    ok = all(e <= cs.SSD_TOL for e in errs.values()) if exact else None
    return {"variant": name, "exact": exact, "within_tol": ok, "ms": ms,
            "row_rel_err": errs}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_variants: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    with open(os.path.join(build.CSRC, "ssd.cu")) as f:
        source = f.read()
    inputs = cs._ssd_inputs(SHAPE, torch.float32)
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    failed = []
    for i, (name, (exact, subs)) in enumerate(VARIANTS.items()):
        path = os.path.join(out_dir, f"ssd_variant_{i}.cu")
        with open(path, "w") as f:
            f.write(variant_source(source, subs))
        t0 = time.perf_counter()
        lib = build.Library(f"ssd_variant_{i}", [path],
                            build.LIBRARIES["ssd"][1])
        row = measure(name, exact, lib, inputs)
        row["build_seconds"] = time.perf_counter() - t0
        row["registers"] = {k["kernel"]: k.get("registers")
                            for k in cs._ptxas(lib.build_log)}
        print(json.dumps(row), flush=True)
        if row["within_tol"] is False:
            failed.append(name)
    print(cs.nvidia_smi())
    if failed:
        print(f"ssd_variants: exact variants out of tolerance: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
