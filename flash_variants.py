#!/usr/bin/env python3
"""The bf16 dK/dV kernel at head_dim 160, in one pass and in two, on one
NVIDIA H100.

    python3 flash_variants.py

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(each a text substitution on the source, compiled for bf16 at head_dim
128 and 160 only, all variants at once) and times the dK/dV wrapper call
with ``chip_smoke.cuda_time`` at stablelm-12b's layer shape (1, 32, 2048,
160), causal, and at head_dim 128 on the same shape. As it is, dK/dV runs
at D = 160 as two passes (dV, then dK); the variants run it in one pass,
or run one of the two passes alone. A variant is a measurement, not a
design: a pass alone computes half the outputs on purpose. Each variant's
dK and dV are held against their plain versions and the largest row
error is printed beside its times and bound; the variants marked exact
must stay within ``chip_smoke.TOL``. Each kernel's registers and spills
come from ``nvcc -Xptxas -v``. Prints one JSON line per variant, then the
card's name and power limit. Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPE = (1, 32, 2048, 160)
HEAD_DIMS = (128, 160)

_TWO_PASSES = "  if constexpr (D <= 128) {"
_DV_PASS = "    const int e = bwd_dkdv_pass<D, 1>("
_DK_PASS = "    if (e != 0) return e;\n    return bwd_dkdv_pass<D, 2>("

# name: (exact, [(old, new), ...])
VARIANTS = {
    "as is (two passes at 160)": (True, []),
    "one pass at 160": (True, [
        (_TWO_PASSES, "  if constexpr (D <= 160) {")]),
    "dV pass alone at 160": (False, [
        (_DK_PASS, "    if (e != 0 || D > 0) return e;\n"
                   "    return bwd_dkdv_pass<D, 2>(")]),
    "dK pass alone at 160": (False, [
        (_DV_PASS, "    const int e = 0;\n"
                   "    if (D < 0) bwd_dkdv_pass<D, 1>(")]),
}


def variant_source(text: str, subs) -> str:
    """The source with each substitution made and its dispatch cut to bf16
    at ``HEAD_DIMS``; raises if a substitution finds nothing, so a stale
    variant fails instead of timing the original."""
    keep = tuple(f"if (dtype == 1 && d == {d})" for d in HEAD_DIMS)
    text = "\n".join(ln for ln in text.split("\n")
                     if not ln.lstrip().startswith("if (dtype ==")
                     or ln.lstrip().startswith(keep))
    for old, new in subs:
        if old not in text:
            raise ValueError(f"substitution not found: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def measure(name, exact, library):
    """Times, bounds and largest row errors of the dK/dV wrapper call at
    each head dim."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    build._LOADED["flash_attention"] = library
    row = {"variant": name, "exact": exact, "ms": {}, "bound_ms": {},
           "row_rel_err": {}}
    for d in HEAD_DIMS:
        shape = SHAPE[:3] + (d,)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(dim=-1)
        got = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                          causal=True)
        want = ref.attention_bwd_dkdv_ref(q, k, v, do, lse, delta,
                                          causal=True)
        torch.cuda.synchronize()
        row["row_rel_err"][d] = max(cs._row_err(g, w)
                                    for g, w in zip(got, want))
        row["ms"][d] = cs.cuda_time(lambda: fa.flash_attention_bwd_dkdv(
            q, k, v, do, lse, delta, causal=True), iters=20)
        row["bound_ms"][d] = cs._bounds(shape, "bfloat16", True, 0)[
            "flash_bwd_dkdv"]["bound_ms"]
    tol = cs.TOL["bfloat16"]
    row["within_tol"] = (all(e <= tol for e in row["row_rel_err"].values())
                         if exact else None)
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    with open(os.path.join(build.CSRC, "flash_attention.cu")) as f:
        source = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (exact, subs) in enumerate(VARIANTS.values()):
        paths.append(os.path.join(out_dir, f"flash_variant_{i}.cu"))
        with open(paths[-1], "w") as f:
            f.write(variant_source(source, subs))
    signatures = build.LIBRARIES["flash_attention"][1]
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = list(pool.map(
            lambda ip: build.Library(f"flash_variant_{ip[0]}", [ip[1]],
                                     signatures), enumerate(paths)))
    failed = []
    for (name, (exact, _)), lib in zip(VARIANTS.items(), libs):
        row = measure(name, exact, lib)
        row["build_seconds"] = lib.build_seconds
        row["ptxas"] = [k for k in cs._ptxas(lib.build_log)
                        if "dkdv" in k["kernel"]]
        print(json.dumps(row), flush=True)
        if row["within_tol"] is False:
            failed.append(name)
    print(cs.nvidia_smi())
    if failed:
        print(f"flash_variants: exact variants out of tolerance: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
