#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main path (``src/repro_torch``): co-scheduled,
gradient-accumulated training of minicpm-2b and qwen2-vl-2b at full
published width, with attention on the hand-written CUDA flash kernels.
Phases, in order; each prints its own line and any failure exits
non-zero:

1. build    - builds the kernels from ``src/repro_torch/kernels/csrc``.
2. parity   - each kernel against its plain PyTorch version on the card,
              at the main path's shapes plus a ragged-S f32 case, a
              non-causal case and a window case; times kernel, plain
              version and the PyTorch library call (SDPA, a yardstick
              the port never calls).
3. solo     - minicpm-2b through ``ScheduleExecutor``: 3 steps at s = 4,
              a reconfig to s = 2, 2 steps, one ragged step (B = 5,
              b = 2, s = 3), finish; launch counts must equal
              layers x micro-batches (x 2 forward launches for remat).
4. pair     - ``measure_pair(minicpm-2b, qwen2-vl-2b)``: solo and pair
              step times and the interference ratios xi.
5. profile  - one profiled step of each model: device time by kernel
              category and the device's busy share of the step.
6. accum    - on the card, accumulated == full-batch gradients on
              reduced configs in f32 (the reference's test tolerance).

Then the card's name and power limit, the ``kernels`` JSON line, and as
the last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX
or of the JAX package. Needs one card.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEQ = 2048
BATCH = 4
# Tolerances of kernel vs plain version, on the largest per-row relative
# error: over the rows of each output (its last axis; each lse entry is a
# row of one), ||kernel - plain|| / max(||plain||, median row norm). A
# kernel that is wrong on any row shows at that row's own scale. The
# median floor keeps a row whose exact value is 0 (dQ of query 0 under the
# causal mask, where dS = P (dO.v0 - dO.O0) = 0) from dividing roundoff
# by roundoff. f32: the two sum up to 2048 products in different orders;
# the card gives <= 2.5e-6, the limit is 4x that. bf16: both round their
# f32 result to bf16, a relative step of 2**-8 per element; the card gives
# <= 2.8e-3, the limit is two such steps.
TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# published H100 SXM peaks (NVIDIA data sheet), dense
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
REPLACES = {
    "flash_fwd": "src/repro/kernels/flash_attention.py:76",
    "flash_bwd_dq": "src/repro/kernels/flash_attention.py:191",
    "flash_bwd_dkdv": "src/repro/kernels/flash_attention.py:218",
}
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------- #
# phase 1: build
# ---------------------------------------------------------------------- #
def phase_build():
    from repro_torch.kernels.build import flash_attention_library
    t0 = time.perf_counter()
    lib = flash_attention_library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=lib.build_seconds, library=os.path.relpath(lib.path,
                                                                 ROOT),
        ptxas=ptxas)


# ---------------------------------------------------------------------- #
# phase 2: kernel parity and timing
# ---------------------------------------------------------------------- #
def _pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) score entries the mask keeps: the work this data needs."""
    from repro_torch.kernels.ref import score_mask
    return int(score_mask(s, causal=causal, window=window,
                          device="cpu").sum())


def _bounds(shape, dtype_name, causal, window) -> dict:
    """Least milliseconds each kernel could take on an H100: the larger of
    bytes over the memory rate (inputs read once, outputs written once)
    and FLOPs over the peak for the input type."""
    b, h, s, d = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    mat = b * h * s * d * elt
    row = b * h * s * 4
    pairs = b * h * _pairs(s, causal, window)
    work = {
        # QK^T and PV
        "flash_fwd": (4 * mat + row, 4 * d * pairs),
        # QK^T, dO V^T, dS K
        "flash_bwd_dq": (5 * mat + 2 * row, 6 * d * pairs),
        # QK^T, dO V^T, P^T dO, dS^T Q
        "flash_bwd_dkdv": (6 * mat + 2 * row, 8 * d * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops
                     else "operations"}
    return out


def _row_err(got, want) -> float:
    """Largest per-row relative error (see ``TOL``)."""
    import torch
    g, w = got.float(), want.float()
    cols = w.shape[-1] if w.dim() == 4 else 1
    g, w = g.reshape(-1, cols), w.reshape(-1, cols)
    norm = w.norm(dim=1)
    return float(((g - w).norm(dim=1)
                  / torch.maximum(norm, norm.median())).max())


def _abs_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def parity_case(label, shape, dtype, causal, window, timed):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for _ in range(4))
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = ref.attention_ref(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq_ref = ref.attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    dk_ref, dv_ref = ref.attention_bwd_dkdv_ref(q, k, v, do, lse, delta,
                                                **kw)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    pairs = {"flash_fwd": ((o, o_ref), (lse, lse_ref)),
             "flash_bwd_dq": ((dq, dq_ref),),
             "flash_bwd_dkdv": ((dk, dk_ref), (dv, dv_ref))}
    # the whole autograd.Function (kernels, delta in torch) against the
    # same composition of plain versions, on the same cotangent
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves,
                                do)
    delta_ref = (do.float() * o_ref.float()).sum(dim=-1)
    plain = (ref.attention_bwd_dq_ref(q, k, v, do, lse_ref, delta_ref,
                                      **kw),
             *ref.attention_bwd_dkdv_ref(q, k, v, do, lse_ref, delta_ref,
                                         **kw))
    pairs["function"] = tuple(zip(grads, plain))
    if dtype == torch.float32:
        # and against autograd through the plain forward: the true
        # gradient. In bf16 the two differ by design (delta is taken from
        # the bf16-rounded O, as in the reference's kernel path), so this
        # is held in f32 only.
        leaves_r = [t.detach().requires_grad_(True) for t in (q, k, v)]
        grads_r = torch.autograd.grad(
            ref.attention_ref(*leaves_r, **kw)[0], leaves_r, do)
        pairs["autograd"] = tuple(zip(grads, grads_r))
    torch.cuda.synchronize()
    errs = {n: max(_row_err(a, b) for a, b in ps)
            for n, ps in pairs.items()}
    abs_errs = {n: max(_abs_err(a, b) for a, b in ps)
                for n, ps in pairs.items()}
    tol = TOL[dname]
    row = {"case": label, "shape": list(shape), "dtype": dname,
           "causal": causal, "window": window, "tol": tol,
           "row_rel_err": errs, "max_abs_err": abs_errs,
           "max_abs_plain": {n: float(t.float().abs().max()) for n, t in (
               ("o", o_ref), ("dq", dq_ref), ("dk", dk_ref),
               ("dv", dv_ref))}}
    bad = {n: e for n, e in errs.items() if not e <= tol}
    if bad:
        log("parity", **row)
        raise AssertionError(f"kernel disagrees with its plain version in "
                             f"{label}: {bad} > {tol}")
    if not timed:
        log("parity", **row)
        return None

    fns = {
        "flash_fwd": (lambda: fa.flash_attention_fwd(q, k, v, **kw),
                      lambda: ref.attention_ref(q, k, v, **kw)),
        "flash_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              **kw),
            lambda: ref.attention_bwd_dq_ref(q, k, v, do, lse, delta,
                                             **kw)),
        "flash_bwd_dkdv": (
            lambda: fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                **kw),
            lambda: ref.attention_bwd_dkdv_ref(q, k, v, do, lse, delta,
                                               **kw)),
    }
    # library yardstick: SDPA on the same inputs in its (B, H, S, D)
    # layout; its backward computes dQ, dK and dV in one call
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    lib_fwd = cuda_time(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), iters=10)
    lib_bwd = cuda_time(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do, retain_graph=True), iters=10)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkdv": lib_bwd}
    bounds = _bounds(shape, dname, causal, window)
    timing = {}
    for name, (kern, plain) in fns.items():
        timing[name] = {"ms": cuda_time(kern, iters=10),
                        "plain_ms": cuda_time(plain, iters=3),
                        "library_ms": library[name], **bounds[name]}
    row["timing"] = timing
    log("parity", **row)
    return abs_errs, timing


def phase_parity():
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    main = parity_case("minicpm-2b", (1, 36, SEQ, 64), bf16, True, 0, True)
    parity_case("qwen2-vl-2b", (1, 12, SEQ, 128), bf16, True, 0, True)
    parity_case("ragged-f32", (1, 4, 1000, 128), f32, True, 0, False)
    parity_case("noncausal-f32", (2, 2, 320, 64), f32, False, 0, False)
    parity_case("window", (1, 4, 1000, 64), bf16, True, 200, False)
    return main


# ---------------------------------------------------------------------- #
# phase 3: solo run through the executor
# ---------------------------------------------------------------------- #
def _expect(n_layers: int, micro: int) -> dict:
    # remat recomputes the forward in the backward: two forward launches
    return {"flash_fwd": 2 * n_layers * micro,
            "flash_bwd_dq": n_layers * micro,
            "flash_bwd_dkdv": n_layers * micro}


def _check_launches(phase: str, expected: dict) -> dict:
    from repro_torch.kernels.flash_attention import LAUNCHES
    got = dict(LAUNCHES)
    if got != expected or min(got.values()) == 0:
        raise AssertionError(f"{phase}: launches {got} != expected "
                             f"{expected}")
    return got


def _check_loss(phase: str, loss: float) -> None:
    if not math.isfinite(loss):
        raise AssertionError(f"{phase}: loss {loss} is not finite")


def phase_solo():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels.flash_attention import reset_launches
    from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
    cfg = get_config("minicpm-2b")
    ex = ScheduleExecutor()
    spec = JobSpec(cfg, batch=BATCH, seq=SEQ, seed=0)
    ex.submit("minicpm", spec, steps=5)
    ex.start("minicpm", sub_batch=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    micro = 0
    schedule = [(None, 3), (2, 2)]          # (reconfig sub-batch, steps)
    for sub, n in schedule:
        if sub is not None:
            ex.reconfigure("minicpm", sub)
        run = ex.runs["minicpm"]
        for _ in range(n):
            res = ex.step_group(["minicpm"])
            loss = res["losses"]["minicpm"]
            _check_loss("solo", loss)
            micro += run.accum_steps
            log("solo", job="minicpm", step=run.steps_done,
                sub_batch=run.sub_batch, accum_steps=run.accum_steps,
                loss=loss, walltime_s=res["walltime"])
    # the ragged step: the same params and moments at B = 5, b = 2 (s = 3)
    run = ex.runs["minicpm"]
    state = (run.params, run.opt,
             make_batch(cfg, 5, SEQ, seed=0, device="cuda"))
    ex.finish("minicpm")
    spec5 = JobSpec(cfg, batch=5, seq=SEQ, seed=0)
    ex.submit("minicpm-ragged", spec5, steps=1)
    ex.start("minicpm-ragged", sub_batch=2, state=state)
    del state
    res = ex.step_group(["minicpm-ragged"])
    ragged = ex.runs["minicpm-ragged"]
    loss = res["losses"]["minicpm-ragged"]
    _check_loss("solo", loss)
    micro += ragged.accum_steps
    log("solo", job="minicpm-ragged", step=ragged.steps_done, batch=5,
        sub_batch=ragged.sub_batch, accum_steps=ragged.accum_steps,
        loss=loss, walltime_s=res["walltime"])
    ex.finish("minicpm-ragged")
    if micro != 3 * 4 + 2 * 2 + 3:
        raise AssertionError(f"solo: {micro} micro-batches, expected 19")
    launches = _check_launches("solo", _expect(cfg.n_layers, micro))
    log("solo", summary=True, micro_batches=micro, launches=launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del ex
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------- #
# phase 4: the co-scheduled pair
# ---------------------------------------------------------------------- #
def phase_pair(iters: int = 2):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.coschedule import measure_pair
    from repro_torch.kernels.flash_attention import reset_launches
    from repro_torch.launch.cluster import JobSpec
    cfg_a, cfg_b = get_config("minicpm-2b"), get_config("qwen2-vl-2b")
    s = 4                                    # sub-batch 1 at B = 4
    spec_a = JobSpec(cfg_a, batch=BATCH, accum_steps=s, seq=SEQ, seed=0)
    spec_b = JobSpec(cfg_b, batch=BATCH, accum_steps=s, seq=SEQ, seed=1)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    r = measure_pair(spec_a, spec_b, iters=iters)
    # solo a, solo b, then the pair: each (iters + 1) steps incl. warm-up
    layer_micro = (iters + 1) * 2 * (cfg_a.n_layers * s + cfg_b.n_layers * s)
    launches = _check_launches("pair", {
        "flash_fwd": 2 * layer_micro, "flash_bwd_dq": layer_micro,
        "flash_bwd_dkdv": layer_micro})
    for key in ("t_a_solo", "t_b_solo", "t_pair"):
        if not (math.isfinite(r[key]) and r[key] > 0):
            raise AssertionError(f"pair: {key} = {r[key]}")
    log("pair", a="minicpm-2b", b="qwen2-vl-2b", accum_steps=s, **r,
        launches=launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------- #
# phase 5: where a step's device time goes
# ---------------------------------------------------------------------- #
def _category(kernel: str) -> str:
    if "flash_fwd_kernel" in kernel or "flash_bwd_" in kernel:
        return "attention (port kernels)"
    low = kernel.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def phase_profile():
    """One profiled step per model at s = 4 after a warm-up step: device
    time by kernel category and the device's busy share of the step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
    from repro_torch.models import param_count
    for name in ("minicpm-2b", "qwen2-vl-2b"):
        ex = ScheduleExecutor()
        spec = JobSpec(get_config(name), batch=BATCH, accum_steps=4,
                       seq=SEQ, seed=0)
        ex.submit(name, spec, steps=2)
        ex.start(name)
        n_params = param_count(ex.runs[name].params)
        ex.step_group([name])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = ex.step_group([name])
        by_cat, top = {}, []
        for e in prof.key_averages():
            # kernels only: a host op also reports its kernels' time
            if e.device_type != DeviceType.CUDA:
                continue
            t = e.self_device_time_total / 1e3          # us -> ms
            cat = _category(e.key)
            by_cat[cat] = by_cat.get(cat, 0.0) + t
            top.append((t, e.key[:90], e.count))
        top.sort(reverse=True)
        device_ms = sum(by_cat.values())
        wall_ms = res["walltime"] * 1e3
        log("profile", model=name, params=n_params, accum_steps=4,
            step_wall_ms=wall_ms,
            device_ms=device_ms if device_ms else "not measured",
            busy_share=device_ms / wall_ms if device_ms else "not measured",
            by_category_ms=by_cat,
            top_kernels=[{"ms": t, "name": n, "calls": c}
                         for t, n, c in top[:8]])
        del ex
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# phase 6: accumulated == full batch on the card
# ---------------------------------------------------------------------- #
def phase_accum():
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import init_params
    from repro_torch.train import (TrainConfig, accumulate_gradients,
                                   make_loss_and_grad)
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("minicpm-2b", "qwen2-vl-2b"):
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="float32")
        params = init_params(cfg, 0)
        lg = make_loss_and_grad(cfg, TrainConfig())
        for batch_size, steps in ((8, 4), (5, 3)):
            batch = make_batch(cfg, batch_size, 128)
            loss_full, g_full = accumulate_gradients(lg, params, batch, 1)
            loss_acc, g_acc = accumulate_gradients(lg, params, batch, steps)
            worst = 0.0
            for key, a in flatten(g_acc).items():
                b = flatten(g_full)[key]
                torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-6)
                worst = max(worst, float((a - b).abs().max()))
            torch.testing.assert_close(loss_acc, loss_full, rtol=1e-5,
                                       atol=1e-6)
            log("accum", model=cfg.name, batch=batch_size,
                accum_steps=steps, loss_full=float(loss_full),
                loss_acc=float(loss_acc), max_abs_grad_diff=worst,
                rtol=5e-4, atol=5e-6)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    t0 = time.perf_counter()
    phase_build()
    errs, timing = phase_parity()
    solo = phase_solo()
    phase_pair()
    phase_profile()
    phase_accum()
    kernels = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": solo[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log("done", seconds=time.perf_counter() - t0)
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
