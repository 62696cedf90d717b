#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's paths (``src/repro_torch``) at full published width:
co-scheduled, gradient-accumulated training of minicpm-2b and
qwen2-vl-2b with attention on the hand-written CUDA flash kernels; the
calibration of (alpha, beta, xi) from those steps and the replay of an
SJF-BSBF schedule simulated on them through the executor, and every
policy compared on them, on the paper's traces and at 1024 GPUs; the
executor's fault recovery (checkpoints, restart, retry, member drop)
and the training driver; training of the hybrid zamba2-7b (36 of its
81 layers) on the CUDA Mamba2 SSD chunk-scan kernels and the flash kernels at head_dim 112;
serving (prefill, KV-cache decode and the continuous-batching
``DecodeEngine``) on the flash-attention forward and the two CUDA
flash-decode kernels; and serving zamba2-7b at all 81 layers, its
prefill on the SSD forward with a state in and out and the flash
forward, its decode on the flash-decode kernels at head_dim 112; and the
remaining dense families and MoE: stablelm-12b on the flash kernels at
head_dim 160, glm4-9b decoding over a sliding window's ring buffer on the
linear decode kernel, granite-moe-3b-a800m's MoE layers; and the last
two families: xlstm-1.3b (no kernel: its mLSTM and sLSTM are plain
PyTorch, as the reference's are plain JAX) and whisper-tiny, whose
cross-attention takes the flash kernels with Sk != Sq, backward
included, and the linear decode kernel; the decode kernels' split
tuned per shape class on the card; the fleet, a master leasing
whisper-tiny jobs to two agent processes that share the card; and the
training driver on the reference's sharding plan as DTensors, with the
dry-run of that plan on the production meshes. Phases,
in order; each prints its own line and any failure exits non-zero:

1. build    - builds the three kernel libraries (flash attention, flash
              decode, SSD) from ``src/repro_torch/kernels/csrc``, one
              ``nvcc -c`` per source, all started together (flash
              decode's kernel instances in one source per dtype and
              head_dim), then one link a library; each kernel compiled
              once.
2. parity   - each kernel against its plain PyTorch version on the card,
              at the main paths' shapes plus ragged-S, non-causal and
              window cases in f32 (the scalar kernels) and in bf16 (the
              tensor-core forward, dQ and dK/dV, each edge at head_dim
              64, 112 and 128; the bf16 dS form and dQ's largest
              error reported), head_dim 112 (bf16 at zamba2's shape and
              ragged f32), the forward at a query offset in f32 and
              bf16 (the suffix prefill; its rows must equal the
              one-shot forward's bitwise), a length-0 slot, a ragged
              cache length and one kv head (decode), a slot's decode
              row alone and among 8 slots, linear and paged (bitwise
              equal), and the SSD forward (with and without per-chunk
              states) and backward at zamba2's layer shape, at a ragged
              S with P 128, N 16, and with bf16 inputs, each also
              against an f64 evaluation, and each of their four passes
              (state and chunk pass of each direction) alone against
              its plain version; the SSD forward with an initial and a
              final state (a prefill's form) at one zamba2 layer
              (S 1024), at a ragged S and from bf16 inputs, against its
              plain version and an f64 evaluation; decode at head_dim
              112 (zamba2's shared block), linear and paged, f32 and
              bf16, and a slot's row alone and among 8 slots; every
              attention case of head_dim 112 also at 160
              (stablelm-12b's layer shape timed, f32 and bf16 ragged,
              non-causal, window, query offset; decode linear and
              paged, f32 and bf16, timed, alone == among 8; the build
              prints the D = 160 instances' registers and spills); the
              ring case: glm4-9b's decode (B 3, 32 heads over 2, 128)
              over a ring of 8192 rows, two slots past the window and
              one partly filled (index 5000),
              the linear kernel at lengths min(index + 1, 8192) against
              the reference's ring mask, timed; whisper-tiny's
              cross-attention (q 448 rows over k/v 1500, 6 heads of
              64, B 8, non-causal) forward, dQ and dK/dV in bf16
              (timed, bound at (Sq, Sk)) and f32, a ragged Sq (37)
              and Sq > Sk (300 over 130) in both, and its decode over
              1500 encoder rows (timed); times
              kernel, plain version
              and the PyTorch library call (SDPA, a yardstick the port
              never calls; none exists for the SSD scan), and the host's
              time to issue one decode wrapper call.
3. solo     - minicpm-2b through ``ScheduleExecutor``: 3 steps at s = 4,
              a reconfig to s = 2, 2 steps, one ragged step (B = 5,
              b = 2, s = 3), finish; launch counts must equal
              layers x micro-batches (x 2 forward launches for remat).
4. pair     - ``measure_pair(minicpm-2b, qwen2-vl-2b)``: solo and pair
              step times and the interference ratios xi.
5. calibrate - ``run_calibration`` on minicpm-2b and qwen2-vl-2b at full
              width and depth, bf16, seq 2048, B = 4 at accum 1, sweep
              points 4, 2, 1; the cross pair and qwen2-vl-2b with itself
              (minicpm-2b with itself, ~82 GB reckoned, is left out).
              Each measurement's min / median / max step beside its
              mean, each xi beside the range its steps give; the
              artifact written and read back (alpha, beta, t_iter_solo,
              xi, structural xi). Required: finite positive times,
              beta > 0, xi > 1, launch counts exact.
6. replay   - ``launch.replay``'s scenario on minicpm-2b at 10 of 40
              layers and qwen2-vl-2b at 7 of 28 (full width, bf16, seq
              2048, B = 4): its own calibration (every pair), SJF-BSBF
              with donor rescaling on it, the plan executed, each job
              re-run solo. Required: a 3-way group, A shrunk then
              restored, quotas summing to and every job taking exactly
              ``job.iters`` steps, launch counts exact, and every job's
              final parameters bitwise its solo re-run's. Prints each
              job's predicted and measured seconds and their error.
6b. policies - on the host: all seven policies (FIFO, SJF, SRSF,
              Tiresias, Pollux-like, SJF-FFS, SJF-BSBF) (a) on the
              profiles and xi that phase 5 measured on this card (the
              calibrated mode of ``table2_physical``: 30 jobs on 2 x 2
              GPUs), (b) on the paper's physical trace (4 x 4 GPUs) and
              its 240- and 480-job traces (16 x 4), (c) SJF and SJF-BSBF
              on a Philly-shaped trace of 5000 jobs at 1024 GPUs.
              Prints avg JCT, queueing, makespan, preemptions and
              seconds per policy, the paper's two headline checks (not
              gated) and, for (c), events per second per decision path.
              Required: every job finishes, a second run gives the same
              log, heap == scan (rel 1e-6), and SJF-BSBF's grid ==
              batched == scalar logs.
7. recovery - minicpm-2b at 2 of 40 layers (qwen2-vl-2b at 2 of 28),
              full width, bf16, seq 2048, B = 4, checkpoints in a
              temporary directory removed at the end: (a) 5 steps
              uninterrupted against a run with a checkpoint every 2
              steps, a scripted fatal fault at call 4 and ``restart``:
              params, moments, step and loss at step 5 bitwise equal,
              2 checkpoints written; (b) a transient fault retried once,
              bitwise no fault; (c) qwen2-vl-2b dropped from the pair by
              a fatal fault, minicpm-2b bitwise its solo run; (d) the
              same through a one-phase ``execute`` plan. Flash launch
              counts exact (a retried or dropped call launches nothing).
              Prints the checkpoint's bytes and write seconds, its stored
              CRC beside one recomputed from the file, the step time with
              and without a write in flight, peak memory. Then the
              reduced f32 qwen2-vl-2b engine, dense and paged, with a
              transient fault before segment 1: tokens those of the
              fault-free run, one retry; an exhausted budget raises.
8. train    - ``launch.quickstart`` for 60 steps on the card (the loss
              must fall; s/step), then ``launch.train`` on minicpm-2b at
              full width and 2 of its 40 layers (a 4.05 GB checkpoint;
              full depth trains in phases 3-5), bf16, B = 4, seq 2048,
              accum 2, 3 steps, with a checkpoint (its CRC, losses and
              launches are phase 19's yardstick): finite losses, exact
              flash launches.
9. profile  - one profiled step of each model at s = 2: device time by
              kernel category and the device's busy share of the step.
10. hybrid  - zamba2-7b at 36 of 81 layers through ``ScheduleExecutor``:
              2 steps at s = 4, a reconfig to s = 2, one ragged step
              (B = 5, b = 2); launch counts must equal their expected
              values (SSD per layer, flash per shared-block
              application); ``measure_pair(zamba2-7b@36, qwen2-vl-2b)``
              and one profiled step.
11. accum   - on the card, accumulated == full-batch gradients on
              reduced configs in f32 (the reference's test tolerance),
              the hybrid at one and two units.
12. serve   - minicpm-2b ``generate``: batch 4, 1024-token prompts,
              16 greedy tokens, ``engine="scan"`` and ``"eager"`` (equal
              tokens); prefill and per-token times, launch counts.
13. engine  - qwen2-vl-2b ``DecodeEngine``, 8 slots, 16 requests, run
              dense, paged and prefix-shared: paged == dense,
              prefix-shared == private and two requests == their solo
              ``generate`` (required); whether cuBLAS rows depend on the
              row count (reported); decode tokens/s (admission
              excluded), pages, hit rate, launch counts. Then the same
              three engines and solo generation on a reduced config in
              f32, where every token identity is required.
14. autotune - ``kernels/autotune.py``'s sweep on the card (the decode
              split 128 / 256 / 512 per class, one split per (head_dim,
              dtype); attention's and the SSD's one form each; each
              beside the plain version and SDPA) into a temporary table:
              each class's winner, t_best, t_default, t_ref, t_lib;
              required: each (head_dim, dtype) whose split moved off 256,
              timed afresh, no slower there than at 256 (within 1 %);
              the host cost of ``ops._resolve`` with and without the
              table. Under the table: each split against the plain
              decode version, linear and paged, at head_dim 64 / 112 /
              128 / 160, bf16 and f32; ``ops`` takes the tuned split;
              the reduced f32 engines' identities (paged == dense,
              engine == solo, prefix-shared == private) with
              620-1120-token prompts, bitwise, under the tuned table and
              tables forced to split 128 and 512. Every other phase runs
              with no table installed, and it ends with none.
15. hybrid_serve - zamba2-7b at 81 layers, bf16: ``generate`` at batch 4,
              1024-token prompts, max_len 4096, 16 greedy tokens (prefill
              ms, ms per decode step, tokens/s, peak memory; launches
              exact: ``ssd_fwd`` 81 and ``flash_fwd`` 9 per prefill,
              ``flash_decode`` 9 per step); a profile of 2 decode steps;
              the ``DecodeEngine`` with 8 slots, dense and paged, on 16
              requests of 256-1024 prompt tokens and 16-32 new tokens:
              paged == dense and engine == solo ``generate`` (required);
              ``generate`` (16 tokens) with no table, under the
              ``autotune`` phase's table (its split at head_dim 112 is
              the shared block's), again, and with none: ms a decode
              step each, reported; then dense, paged and solo on a
              reduced zamba2 (18 layers) in f32, every token identity
              required.
16. families - bf16, full width: (a) stablelm-12b at all 40 layers
              through ``generate`` (batch 4, 1024-token prompts, 16
              tokens, scan == eager; 40 flash forwards a prefill, 40
              decodes a step) and a decode profile; (b) stablelm-12b at
              8 of 40 layers through ``ScheduleExecutor`` (2 steps at
              s = 4, a reconfig to s = 2, 1 step; exact launches of the
              head_dim 160 kernels); (c) glm4-9b at all 40 layers with
              the reference's long-context window of 8192, 2 prompts of
              9216 tokens, 16 tokens, scan == eager, 8192 cache rows a
              layer; (d) granite-moe-3b-a800m, einsum dispatch, at 16
              of 32 layers through the executor as (b) and a profiled
              step with the MoE einsums' device time, at all 32 through
              ``generate`` (batch 4, 1024, 16 tokens) and a decode
              profile; (e) reduced f32:
              a windowed glm4-9b (window 16) dense engine == solo;
              granite-moe and llama4-maverick under the dense dispatch
              (capacity factor 8): paged == dense, prefix-shared ==
              private, engine == solo.
17. xlstm_whisper - bf16, full width: (a) xlstm-1.3b at 8 of 48 layers
              through ``ScheduleExecutor`` at B 4, seq 256 (one mLSTM
              chunk: the sLSTM's per-token loop took 20.4 s a step at
              512), s = 2, a warm-up and two timed steps, the last
              profiled (kernels, busy share); at all 48 ``generate`` at batch 4,
              1024-token prompts, 16 tokens, scan == eager, and a
              decode profile; every kernel launched 0 times; (b)
              whisper-tiny (4 + 4 layers, 1500 frames) through the
              executor at decoder seq 448, B 8, s = 2 (24 flash
              forwards and 12 each of dQ and dK/dV a micro-batch) and
              ``generate`` at batch 4, 16-token prompts, 16 tokens,
              max_len 448 (12 forwards a prefill, the encoder's 4
              among them; 8 decodes a step); (c) reduced f32: the
              xLSTM engine == solo; Whisper's paged decode == dense
              and scan == eager, bitwise. Prints its seconds.
18. fleet   - whisper-tiny at full size (4 + 4 layers, 1500 frames,
              decoder seq 448, bf16, B 4), seeds 0-3, on the fleet
              test's replay plan (4 jobs, a 3-way sharing group with
              donor reconfigurations, 16 steps): the single-host
              executor, then ``launch.fleet``'s master with two agent
              processes sharing the card, then the same with agent a0
              SIGKILLed after two steps (a checkpoint every second step
              of a job there). Required: every job finishes
              with the single host's steps, loss and checkpoint CRC,
              exactly; the kill detected under ``dead_after`` + 1 s and
              re-dispatched; without it the agents' launches sum to the
              single host's. Prints each lease's seconds, peak memory
              and launches, the checkpoint bytes, the detection latency.
19. sharded - (a) phase 8's ``launch.train`` run again with
              ``--distributed``: an ``nccl`` world of one, a (1, 1)
              ('data', 'model') mesh, DTensor parameters at the
              reference's FSDP x TP placements, the flash kernels on the
              local blocks through ``local_map``. Required: every
              parameter at its placements, per-step losses and the
              checkpoint CRC bitwise phase 8's, flash launches equal to
              phase 8's. Prints both runs' seconds a step and peak
              memory. (b) ``launch.dryrun`` on the host, in processes
              started before phase 16 at the lowest CPU priority:
              minicpm-2b at train_4k on 16 x 16 and 2 x 16 x 16,
              qwen2-vl-2b on 16 x 16, and on 16 x 16 the records that
              failed before their repair: llama4-maverick's and
              zamba2-7b's prefill_32k, xlstm-1.3b's train_4k and
              decode_32k, llama3-405b's train_4k; each on a fake process
              group of 256 or 512 ranks, loops counted from their
              trips. Required: every record ``ok``. Prints each record's
              host seconds, per-device FLOPs, collective bytes, argument
              and temporary bytes against this card's memory, roofline
              terms.

Every log line carries ``at_s``, the seconds since the script started;
the ``done`` line gives each phase's seconds beside the 1200 s the
whole run must stay under. Then the card's name and power limit, the
``kernels`` JSON line, and as the last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX
or of the JAX package. Needs one card.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEQ = 2048
BATCH = 4
# Tolerances of kernel vs plain version, on the largest per-row relative
# error: over the rows of each output (its last axis; each lse entry is a
# row of one), ||kernel - plain|| / max(||plain||, median nonzero row
# norm). A kernel that is wrong on any row shows at that row's own scale.
# The floor keeps a row whose exact value is 0 (dQ of query 0 under the
# causal mask, where dS = P (dO.v0 - dO.O0) = 0; a decode slot of length
# 0) from dividing roundoff, or 0, by 0. It is the median of the nonzero
# norms: with half the rows 0 (a batch-2 decode with one empty slot) the
# median of all norms is 0, and 0 / 0 gives NaN. f32: the two sum up to 2048 products in different orders;
# the card gives <= 2.5e-6, the limit is 4x that. bf16: both round their
# f32 result to bf16, a relative step of 2**-8 per element; the card gives
# <= 2.8e-3, the limit is two such steps.
TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# published H100 SXM peaks (NVIDIA data sheet), dense
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# The SSD kernels against their plain version, f32 outputs. Both run the
# same chunked scan in f32, and the chunk-local cumsum of A dt enters
# every exponent: at these inputs it reaches ~-100 in a chunk, where an
# f32 ulp is 7.6e-6, so each decay factor may differ by ~1e-5 relative
# between two summation orders, and sums with cancellation (d(dA) is a
# suffix sum of terms of both signs) amplify that. The limit is 1e-4;
# the parity rows also report each version's error against an f64
# evaluation of the plain version, which shows which one is off. Outputs
# in bf16 (y, dx from bf16 inputs) take TOL["bfloat16"].
SSD_TOL = 1e-4
REPLACES = {
    "flash_fwd": "src/repro/kernels/flash_attention.py:76",
    "flash_bwd_dq": "src/repro/kernels/flash_attention.py:191",
    "flash_bwd_dkdv": "src/repro/kernels/flash_attention.py:218",
    "flash_decode": "src/repro/kernels/flash_decode.py:38",
    "flash_decode_paged": "src/repro/kernels/flash_decode.py:132",
    "ssd_fwd": "src/repro/kernels/mamba2_scan.py:49",
    "ssd_bwd": "src/repro/kernels/mamba2_scan.py:90",
}
SOURCES = {
    "flash_fwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_bwd_dq": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_bwd_dkdv": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cuh",
    "flash_decode_paged": "src/repro_torch/kernels/csrc/flash_decode.cuh",
    "ssd_fwd": "src/repro_torch/kernels/csrc/ssd.cu",
    "ssd_bwd": "src/repro_torch/kernels/csrc/ssd.cu",
}
# each SSD wrapper call launches its state pass, then its chunk pass
SSD_PASSES = {"ssd_fwd": ("fwd_state", "fwd_chunk"),
              "ssd_bwd": ("bwd_state", "bwd_chunk")}
SSD_KERNELS = ("ssd_fwd_state_kernel", "ssd_fwd_chunk_kernel",
               "ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel")
# the decode kernels' template instances: T f32 or bf16, D 64, 112, 128
# or 160, G (query heads a block serves) 1 to 8
DECODE_INSTANCES = {
    name: [f"flash_decode_split_kernel<T, D, G, {paged}>",
           "flash_decode_merge_kernel<T, D>", "T in {float, __nv_bfloat16}",
           "D in {64, 112, 128, 160}", "G in 1..8"]
    for name, paged in (("flash_decode", "false"),
                        ("flash_decode_paged", "true"))}
# the hybrid: zamba2-7b at full width, 36 of its 81 layers (4 of its 9
# units of nine Mamba2 layers and the shared block)
HYBRID_LAYERS = 36
# serving shapes: a generate run's 16 greedy tokens are the 16 decode steps
# its ms a step is read over, and enough for scan == eager
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, MAX_LEN = 4, 1024, 16, 4096
# the reference's sliding window for full-attention archs at long context
# (``configs/shapes.py``: LONG_CTX_WINDOW)
LONG_WINDOW = 8192
ENGINE_SLOTS, ENGINE_SEGMENT, ENGINE_REQUESTS, SYSTEM_PREFIX = 8, 16, 16, 1024


_T_START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started
    (``at_s``)."""
    fields["at_s"] = round(time.perf_counter() - _T_START, 3)
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


def host_us(fn, iters: int, warmup: int = 1) -> float:
    """Mean microseconds the host takes to issue ``fn()`` (its checks,
    allocations and launches), from an idle card: where this exceeds the
    kernels' device time, ``cuda_time`` reads the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


# ---------------------------------------------------------------------- #
# phase 1: build
# ---------------------------------------------------------------------- #
def _ptxas(build_log: str) -> list:
    """Each kernel's registers, spills and static shared memory from
    ``nvcc -Xptxas -v``; names demangled by ``c++filt`` where it exists."""
    import re
    import shutil
    out = []
    for ln in build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        if entry:
            out.append({"kernel": entry.group(1)})
        elif spill and out:
            out[-1].update(spill_stores=int(spill.group(1)),
                           spill_loads=int(spill.group(2)))
        elif regs and out:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[-1].update(registers=int(regs.group(1)),
                           static_smem=int(smem.group(1)) if smem else 0)
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            k["kernel"] for k in out), capture_output=True, text=True
                               ).stdout.splitlines()
        for k, name in zip(out, names):
            k["kernel"] = name.replace("(anonymous namespace)::", "") \
                .removeprefix("void ").split("(")[0]
    return out


def phase_build():
    from repro_torch.kernels.build import build_all
    t0 = time.perf_counter()
    libs = build_all()
    for name, lib in libs.items():
        ptxas = _ptxas(lib.build_log)
        # each kernel instance is compiled by exactly one of the library's
        # sources (the entries' source declares them extern)
        names = [k["kernel"] for k in ptxas]
        twice = sorted({n for n in names if names.count(n) > 1})
        if not ptxas or twice:
            raise AssertionError(f"build: {name} compiled {len(names)} "
                                 f"kernels, these more than once: {twice}")
        log("build", library=name, nvcc_seconds=lib.build_seconds,
            seconds_by_step=lib.build_steps,
            path=os.path.relpath(lib.path, ROOT), ptxas=ptxas,
            spills=[k["kernel"] for k in ptxas
                    if k.get("spill_stores") or k.get("spill_loads")])
        d160 = [k for k in ptxas if "160" in k["kernel"]]
        if d160:
            log("build", library=name, head_dim=160, instances=d160)
    log("build", seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------- #
# phase 2: kernel parity and timing
# ---------------------------------------------------------------------- #
def _pairs(s: int, causal: bool, window: int, sk=None) -> int:
    """(q, k) score entries the mask keeps among s query rows and sk (s
    unless given) key rows: the work this data needs."""
    from repro_torch.kernels.ref import score_mask
    return int(score_mask(s, causal=causal, window=window, device="cpu",
                          sk=sk).sum())


def _bounds(shape, dtype_name, causal, window, sk=None) -> dict:
    """Least milliseconds each kernel could take on an H100: the larger of
    bytes over the memory rate (inputs read once, outputs written once)
    and FLOPs over the peak for the input type. ``shape`` is q's
    (B, H, Sq, D); k and v have ``sk`` rows (Sq unless given)."""
    b, h, s, d = shape
    sk = s if sk is None else sk
    elt = 2 if dtype_name == "bfloat16" else 4
    mat_q, mat_k = b * h * s * d * elt, b * h * sk * d * elt
    row = b * h * s * 4
    pairs = b * h * _pairs(s, causal, window, sk)
    work = {
        # QK^T and PV: q, k, v in, O and lse out
        "flash_fwd": (2 * mat_q + 2 * mat_k + row, 4 * d * pairs),
        # QK^T, dO V^T, dS K: q, k, v, dO, lse, delta in, dQ out
        "flash_bwd_dq": (3 * mat_q + 2 * mat_k + 2 * row, 6 * d * pairs),
        # QK^T, dO V^T, P^T dO, dS^T Q: q, k, v, dO, lse, delta in, dK,
        # dV out
        "flash_bwd_dkdv": (2 * mat_q + 4 * mat_k + 2 * row, 8 * d * pairs),
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
    floor = norm[norm > 0].median() if bool((norm > 0).any()) else 1.0
    return float(((g - w).norm(dim=1)
                  / torch.clamp_min(norm, floor)).max())


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
        return row

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
    return row


def suffix_case(label, b, h, sk, start, d, dtype):
    """The forward kernel in the suffix prefill's form (query rows at
    absolute positions ``start .. sk - 1`` over all ``sk`` keys) against
    its plain version, and bitwise equal to the same rows of the one-shot
    forward over all ``sk`` rows: what gives a prefix-shared hit's
    suffix prefill the attention bits of a whole-prompt prefill."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    qs = q[:, :, start:].contiguous()
    o, lse = fa.flash_attention_fwd(qs, k, v, causal=True, q_offset=start)
    o_full, lse_full = fa.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = ref.attention_ref(qs, k, v, causal=True,
                                       q_offset=start)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    tol = TOL[dname]
    errs = {"o": _row_err(o, o_ref), "lse": _row_err(lse, lse_ref)}
    same = bool(torch.equal(o, o_full[:, :, start:])
                and torch.equal(lse, lse_full[:, :, start:]))
    row = {"case": label, "shape": [b, h, sk, d], "q_offset": start,
           "dtype": dname, "tol": tol, "row_rel_err": errs,
           "max_abs_err": _abs_err(o, o_ref),
           "suffix_rows_equal_one_shot_rows": same}
    log("parity", **row)
    bad = {n: e for n, e in errs.items() if not e <= tol}
    if bad or not same:
        raise AssertionError(f"forward at a query offset disagrees in "
                             f"{label}: {bad}, equals one-shot rows {same}")


def rect_case(label, b, h, sq, sk, d, dtype, timed):
    """Whisper's cross-attention: sq decoder rows over sk encoder rows,
    non-causal. The forward, dQ and dK/dV kernels and the whole
    autograd.Function against their plain versions (in f32 also against
    autograd through the plain forward), and, if ``timed``, kernel /
    plain / SDPA times and each kernel's bound at (sq, sk)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rand(s):
        return torch.randn((b, h, s, d), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    q, do, k, v = rand(sq), rand(sq), rand(sk), rand(sk)
    kw = dict(causal=False)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = ref.attention_ref(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq_ref = ref.attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    dk_ref, dv_ref = ref.attention_bwd_dkdv_ref(q, k, v, do, lse, delta,
                                                **kw)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves,
                                do)
    delta_ref = (do.float() * o_ref.float()).sum(dim=-1)
    plain = (ref.attention_bwd_dq_ref(q, k, v, do, lse_ref, delta_ref,
                                      **kw),
             *ref.attention_bwd_dkdv_ref(q, k, v, do, lse_ref, delta_ref,
                                         **kw))
    pairs = {"flash_fwd": ((o, o_ref), (lse, lse_ref)),
             "flash_bwd_dq": ((dq, dq_ref),),
             "flash_bwd_dkdv": ((dk, dk_ref), (dv, dv_ref)),
             "function": tuple(zip(grads, plain))}
    if dtype == torch.float32:
        leaves_r = [t.detach().requires_grad_(True) for t in (q, k, v)]
        grads_r = torch.autograd.grad(
            ref.attention_ref(*leaves_r, **kw)[0], leaves_r, do)
        pairs["autograd"] = tuple(zip(grads, grads_r))
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    tol = TOL[dname]
    errs = {n: max(_row_err(a, w) for a, w in ps) for n, ps in pairs.items()}
    row = {"case": label, "rectangular": True, "q": [b, h, sq, d],
           "kv": [b, h, sk, d], "dtype": dname, "causal": False, "tol": tol,
           "row_rel_err": errs,
           "max_abs_err": {n: max(_abs_err(a, w) for a, w in ps)
                           for n, ps in pairs.items()},
           "shapes_ok": dq.shape == q.shape and dk.shape == k.shape}
    bad = {n: e for n, e in errs.items() if not e <= tol}
    if bad or not row["shapes_ok"]:
        log("parity", **row)
        raise AssertionError(f"rectangular kernel disagrees with its plain "
                             f"version in {label}: {bad} > {tol}")
    if timed:
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
        lib_bwd = cuda_time(lambda: torch.autograd.grad(
            sdpa_out, (qg, kg, vg), do, retain_graph=True), iters=10)
        library = {"flash_fwd": cuda_time(
            lambda: F.scaled_dot_product_attention(q, k, v), iters=10),
            "flash_bwd_dq": lib_bwd, "flash_bwd_dkdv": lib_bwd}
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
        bounds = _bounds((b, h, sq, d), dname, False, 0, sk)
        row["timing"] = {
            name: {"ms": cuda_time(kern, iters=10),
                   "plain_ms": cuda_time(plain, iters=3),
                   "library_ms": library[name], **bounds[name]}
            for name, (kern, plain) in fns.items()}
    log("parity", **row)
    return row


def _decode_inputs(gen, b, h, h_kv, s, d, dtype, lengths, page_size):
    """q, a linear cache and the same rows in a shuffled page pool, with
    -1 entries past each slot's length and spare pages of noise."""
    import torch
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, s, h_kv, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    p_tab = -(-s // page_size)
    n_pg = b * p_tab + 8
    perm = torch.randperm(n_pg, generator=gen, device="cuda").tolist()
    pools = [torch.randn((n_pg, page_size, h_kv, d), generator=gen,
                         device="cuda").to(dtype) for _ in range(2)]
    pages = torch.full((b, p_tab), -1, dtype=torch.int32)
    for i, n in enumerate(lengths.tolist()):
        for j in range(-(-min(n, s) // page_size)):
            pg = perm[i * p_tab + j]
            pages[i, j] = pg
            lo, hi = j * page_size, min((j + 1) * page_size, s)
            pools[0][pg, :hi - lo] = k[i, lo:hi]
            pools[1][pg, :hi - lo] = v[i, lo:hi]
    return q, k, v, pools, pages.cuda()


def _decode_bound(lengths, s, h, h_kv, d, dtype_name, page_size=None
                  ) -> dict:
    """Least milliseconds on an H100: every valid K and V row read once
    (each kv head once), q read and O written once, plus lengths and the
    table entries walked; 4 D flops per (slot, head, valid key)."""
    elt = 2 if dtype_name == "bfloat16" else 4
    valid = [min(n, s) for n in lengths]
    b = len(valid)
    nbytes = (sum(valid) * h_kv * d * elt * 2 + 2 * b * h * d * elt + 4 * b)
    if page_size:
        nbytes += 4 * sum(-(-n // page_size) for n in valid)
    flops = 4 * d * h * sum(valid)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_bytes": nbytes}


def decode_case(label, b, h, h_kv, s, d, dtype, lengths, timed,
                page_size=16, split=256, phase="parity"):
    """Both decode kernels against their plain versions on the same rows
    (linear cache and shuffled pool), the same bits from both kernels,
    and, if ``timed``, kernel / plain / SDPA times and the bound. The
    kernels take ``split`` key positions a block (their default 256)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lengths = torch.as_tensor(lengths, device="cuda")
    q, k, v, (kp, vp), pages = _decode_inputs(gen, b, h, h_kv, s, d, dtype,
                                              lengths, page_size)
    g = h // h_kv
    krep, vrep = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    out = fd.flash_decode(q, k, v, lengths, split=split)
    out_p = fd.flash_decode_paged(q, kp, vp, pages, lengths, split=split)
    want = ref.flash_decode_ref(q, krep, vrep, lengths)
    want_p = ref.flash_decode_paged_ref(q, kp, vp, pages, lengths)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    tol = TOL[dname]
    errs = {"flash_decode": _row_err(out, want),
            "flash_decode_paged": _row_err(out_p, want_p)}
    abs_errs = {"flash_decode": _abs_err(out, want),
                "flash_decode_paged": _abs_err(out_p, want_p)}
    empty = [i for i, n in enumerate(lengths.tolist()) if n == 0]
    row = {"case": label, "shape": [b, h, h_kv, s, d], "dtype": dname,
           "page_size": page_size, "split": split,
           "lengths": lengths.tolist(), "tol": tol,
           "row_rel_err": errs, "max_abs_err": abs_errs,
           "max_abs_plain": float(want.float().abs().max()),
           "paged_equals_linear": bool(torch.equal(out, out_p)),
           "empty_slots_zero": all(float(o[i].abs().max()) == 0.0
                                   for o in (out, out_p) for i in empty)}
    bad = {n: e for n, e in errs.items() if not e <= tol}
    if bad or not row["paged_equals_linear"] or not row["empty_slots_zero"]:
        log(phase, **row)
        raise AssertionError(f"decode kernel disagrees in {label}: {bad}, "
                             f"paged == linear {row['paged_equals_linear']}"
                             f", empty slots 0 {row['empty_slots_zero']}")
    if not timed:
        log(phase, **row)
        return errs
    # library yardstick: SDPA with a length mask on (B, H, S, D) kv
    # repeated to H; for the paged row, on the gathered pages
    valid = (torch.arange(s, device="cuda")[None, :]
             < lengths[:, None])[:, None, None, :]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = krep.transpose(1, 2).contiguous(), vrep.transpose(1, 2).contiguous()
    p_tab = pages.shape[1]
    safe = pages.long().clamp_min(0)
    kg, vg = (pool[safe].reshape(b, p_tab * page_size, h_kv, d)
              .repeat_interleave(g, 2).transpose(1, 2).contiguous()
              for pool in (kp, vp))
    valid_p = (torch.arange(p_tab * page_size, device="cuda")[None, :]
               < lengths[:, None])[:, None, None, :]
    fns = {
        "flash_decode": (
            lambda: fd.flash_decode(q, k, v, lengths, split=split),
            lambda: ref.flash_decode_ref(q, k.repeat_interleave(g, 2),
                                         v.repeat_interleave(g, 2), lengths),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=valid)),
        "flash_decode_paged": (
            lambda: fd.flash_decode_paged(q, kp, vp, pages, lengths,
                                          split=split),
            lambda: ref.flash_decode_paged_ref(q, kp, vp, pages, lengths),
            lambda: F.scaled_dot_product_attention(qt, kg, vg,
                                                   attn_mask=valid_p)),
    }
    timing = {}
    for name, (kern, plain, lib) in fns.items():
        timing[name] = {"ms": cuda_time(kern, iters=20),
                        "host_us": host_us(kern, iters=20),
                        "plain_ms": cuda_time(plain, iters=5),
                        "library_ms": cuda_time(lib, iters=20),
                        **_decode_bound(lengths.tolist(), s, h, h_kv, d,
                                        dname, page_size if "paged" in name
                                        else None)}
    row["timing"] = timing
    log(phase, **row)
    return abs_errs, timing


def decode_invariance_case(label, h, h_kv, s, d, dtype, page_size=16):
    """One slot's row alone (B = 1) and among 8 slots of other lengths,
    through the linear kernel (alone: in a cache 300 rows longer) and the
    paged kernel (among 8: through a table 5 pages wider): all four
    bitwise equal. The split-K kernels' splits and merge order depend on
    the slot's length alone, never on B, the capacity or the table."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rng = np.random.default_rng(5)
    lengths = rng.integers(1, s + 1, 8)
    i = 3
    lengths[i] = s - 1095                 # ragged, several splits
    lengths = torch.as_tensor(lengths, device="cuda")
    q, k, v, (kp, vp), pages = _decode_inputs(gen, 8, h, h_kv, s, d, dtype,
                                              lengths, page_size)
    wide = torch.cat([pages, torch.full((8, 5), -1, dtype=torch.int32,
                                        device="cuda")], dim=1).contiguous()
    k1, v1 = (torch.cat([t[i:i + 1], torch.randn(
        (1, 300, h_kv, d), generator=gen, device="cuda").to(dtype)], dim=1)
        for t in (k, v))
    one = slice(i, i + 1)
    outs = {"linear, 8 slots": fd.flash_decode(q, k, v, lengths)[i],
            "linear, alone, longer cache": fd.flash_decode(
                q[one], k1, v1, lengths[one])[0],
            "paged, 8 slots, wider table": fd.flash_decode_paged(
                q, kp, vp, wide, lengths)[i],
            "paged, alone": fd.flash_decode_paged(
                q[one], kp, vp, pages[one].contiguous(), lengths[one])[0]}
    torch.cuda.synchronize()
    want = outs["linear, 8 slots"]
    equal = {n: bool(torch.equal(o, want)) for n, o in outs.items()}
    row = {"case": label, "invariance": True, "shape": [8, h, h_kv, s, d],
           "dtype": str(dtype).replace("torch.", ""), "slot": i,
           "length": int(lengths[i]), "others": lengths.tolist(),
           "bitwise_equal_to_linear_8_slots": equal}
    log("parity", **row)
    if not all(equal.values()):
        raise AssertionError(f"decode row depends on the batch in {label}: "
                             f"{equal}")


def ring_case(label, b, h, h_kv, s, d, dtype, index, window):
    """Decode over a sliding window's ring buffer of ``s`` rows: the linear
    decode kernel with lengths min(index + 1, s), as the model's path
    calls it, against the reference's ring-masked decode
    (``ref.ring_decode_ref``, the mask of each row's absolute position),
    within ``TOL``; timed, with its bound and SDPA under the ring mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    index = torch.as_tensor(index, device="cuda")
    lengths = (index + 1).clamp_max(s)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, s, h_kv, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    g = h // h_kv
    krep, vrep = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    fd.reset_launches()
    out = fd.flash_decode(q, k, v, lengths)
    want = ref.ring_decode_ref(q, krep, vrep, index, window)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    tol = TOL[dname]
    err = _row_err(out, want)
    pos = ref.ring_abs_pos(index, s)
    valid = ((pos <= index[:, None]) & (pos > index[:, None] - window)
             & (pos >= 0))
    row = {"case": label, "ring": True, "shape": [b, h, h_kv, s, d],
           "dtype": dname, "window": window, "index": index.tolist(),
           "lengths": lengths.tolist(), "tol": tol, "row_rel_err": err,
           "max_abs_err": _abs_err(out, want),
           "ring_mask_is_the_prefix": bool(torch.equal(
               valid, torch.arange(s, device="cuda")[None, :]
               < lengths[:, None]))}
    if not (err <= tol and row["ring_mask_is_the_prefix"]):
        log("parity", **row)
        raise AssertionError(f"ring decode disagrees in {label}: {row}")
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (krep, vrep))
    mask = valid[:, None, None, :]
    row["timing"] = {
        "ms": cuda_time(lambda: fd.flash_decode(q, k, v, lengths), iters=20),
        "plain_ms": cuda_time(lambda: ref.ring_decode_ref(
            q, krep, vrep, index, window), iters=5),
        "library_ms": cuda_time(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), iters=20),
        **_decode_bound(lengths.tolist(), s, h, h_kv, d, dname)}
    log("parity", **row)
    return row


def _ssd_inputs(shape, dtype, seed=0):
    """x, dt = softplus(N - 1), A = -exp(N / 2) (f32), Bm, Cm and a
    cotangent dy, as the reference's SSD tests draw them."""
    import torch
    import torch.nn.functional as F
    b, s, h, p, n = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def r(*sh):
        return torch.randn(sh, generator=gen, device="cuda")
    x, dt = r(b, s, h, p), F.softplus(r(b, s, h) - 1)
    a = -torch.exp(r(h) * 0.5)
    bm, cm, dy = r(b, s, n), r(b, s, n), r(b, s, h, p)
    return ([t.to(dtype) for t in (x, dt)] + [a]
            + [t.to(dtype) for t in (bm, cm, dy)])


def _ssd_bounds(shape, dtype_name) -> dict:
    """Least milliseconds each SSD wrapper and each of its passes could take
    on an H100, at the kernels' chunk L = 64: the larger of bytes over the
    memory rate (each input read once, each output written once; the
    forward with its per-chunk states, as training runs it; a pass with the
    states or d(states) it reads or writes) and the chunked algorithm's
    products over the f32 peak (the arithmetic is f32 whatever the input
    type). Beside it the TF32 time, and ``bound_3xtf32_ms``, the route the
    kernels take: three TF32 products for each f32 one. The intra-chunk
    (L, L) products count only the L (L + 1) / 2 causal pairs the output
    needs, as ``_bounds`` counts causal attention."""
    from repro_torch.kernels.ssd import CHUNK as L
    b, s, h, p, n = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    x, row, bc = b * s * h * p * elt, b * s * h * elt, b * s * n * elt
    states = b * h * (s // L) * p * n * 4
    grads = 2 * b * s * h * 4 + 2 * b * s * h * n * 4   # ddt, d(dA), dB, dC
    chunks = b * h * (s // L)
    pairs = L * (L + 1) // 2
    lpn = 2 * L * p * n                 # flops of one (L,P)^T (L,N) product
    work = {
        # over the pairs: C B^T, m (x dt); C state^T, (x w)^T B
        "ssd_fwd": (2 * x + row + 2 * bc + 4 * h + states,
                    chunks * (2 * pairs * (n + p) + 2 * lpn)),
        # the prefill's form: no per-chunk states kept, an initial state
        # read and the final state written
        "ssd_prefill": (2 * x + row + 2 * bc + 4 * h + 2 * b * h * p * n * 4,
                        chunks * (2 * pairs * (n + p) + 2 * lpn)),
        # over the pairs: scores, dscores^T C, dscores B (N), dxdt, dm
        # (P); dxw, y_inter, g, dyec s0, dyec^T C; dx, ddt, d(dA), dB and
        # dC partials out
        "ssd_bwd": (3 * x + row + 2 * bc + 4 * h + states + grads,
                    chunks * (2 * pairs * (3 * n + 2 * p) + 5 * lpn)),
        # the passes: (x w)^T B; then the rest of the forward
        "fwd_state": (x + row + bc + 4 * h + states, chunks * lpn),
        "fwd_chunk": (2 * x + row + 2 * bc + 4 * h + states,
                      chunks * (2 * pairs * (n + p) + lpn)),
        # (dy e)^T C; then the rest of the backward, given d(states)
        "bwd_state": (x + row + bc + 4 * h + states, chunks * lpn),
        "bwd_chunk": (3 * x + row + 2 * bc + 4 * h + 2 * states + grads,
                      chunks * (2 * pairs * (3 * n + 2 * p) + 4 * lpn)),
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


def ssd_pass_rows(args, dyp, timed, bounds):
    """Each of the four SSD passes against its plain version on the same
    inputs (a chunk pass gets the plain state pass's states), each output
    also against an f64 evaluation of the plain version. Returns the rows
    and, if ``timed``, each pass's kernel and plain times."""
    import torch
    from repro_torch.kernels import ref, ssd
    x, dt, a, bm, cm = args
    L = ssd.CHUNK
    st_r = ref.ssd_fwd_state_ref(x, dt, a, bm, chunk=L)
    ds_r = ref.ssd_bwd_state_ref(dt, a, cm, dyp, chunk=L)
    x64, dt64, a64, bm64, cm64 = (t.double() for t in args)
    dy64 = dyp.double()
    st64 = ref.ssd_fwd_state_ref(x64, dt64, a64, bm64, chunk=L)
    ds64 = ref.ssd_bwd_state_ref(dt64, a64, cm64, dy64, chunk=L)
    passes = {  # name: (kernel, plain, f64, output names)
        "fwd_state": (lambda: ssd.fwd_state(x, dt, a, bm),
                      lambda: ref.ssd_fwd_state_ref(x, dt, a, bm, chunk=L),
                      lambda: st64, ("states",)),
        "fwd_chunk": (lambda: ssd.fwd_chunk(x, dt, a, bm, cm, st_r),
                      lambda: ref.ssd_fwd_chunk_ref(x, dt, a, bm, cm, st_r,
                                                    chunk=L),
                      lambda: ref.ssd_fwd_chunk_ref(x64, dt64, a64, bm64,
                                                    cm64, st64, chunk=L),
                      ("y",)),
        "bwd_state": (lambda: ssd.bwd_state(dt, a, cm, dyp),
                      lambda: ref.ssd_bwd_state_ref(dt, a, cm, dyp, chunk=L),
                      lambda: ds64, ("dstates",)),
        "bwd_chunk": (lambda: ssd.bwd_chunk(x, dt, a, bm, cm, st_r, ds_r,
                                            dyp),
                      lambda: ref.ssd_bwd_chunk_ref(x, dt, a, bm, cm, st_r,
                                                    ds_r, dyp, chunk=L),
                      lambda: ref.ssd_bwd_chunk_ref(x64, dt64, a64, bm64,
                                                    cm64, st64, ds64, dy64,
                                                    chunk=L),
                      ("dx", "ddt", "dda", "dbh", "dch")),
    }
    rows, timing = {}, {}
    for name, (kern, plain, wide, names) in passes.items():
        got, want, w64 = ((o,) if torch.is_tensor(o) else tuple(o)
                          for o in (kern(), plain(), wide()))
        torch.cuda.synchronize()
        rows[name] = {
            "row_rel_err": {n: _row_err(k, p)
                            for n, k, p in zip(names, got, want)},
            "tol": {n: TOL["bfloat16"] if k.dtype == torch.bfloat16
                    else SSD_TOL for n, k in zip(names, got)},
            "vs_f64": {n: {"kernel": _row_err(k, d), "plain": _row_err(p, d)}
                       for n, k, p, d in zip(names, got, want, w64)},
            "max_abs_err": {n: _abs_err(k, p)
                            for n, k, p in zip(names, got, want)}}
        if timed:
            timing[name] = {"ms": cuda_time(kern, iters=10),
                            "plain_ms": cuda_time(plain, iters=3),
                            **bounds[name]}
    return rows, timing


def ssd_case(label, shape, dtype, timed):
    """Both SSD wrappers against their plain versions on the same inputs
    (the forward with and without per-chunk states, the backward's raw
    outputs), each also against an f64 evaluation of the plain version;
    the whole padded autograd path against autograd of the plain forward;
    each of the four passes alone against its plain version
    (``ssd_pass_rows``). If ``timed``: kernel and plain times of each
    wrapper and each pass, and the bounds."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, ssd
    x, dt, a, bm, cm, dy = _ssd_inputs(shape, dtype)
    s = shape[1]
    pad = -s % ssd.CHUNK
    xp = F.pad(x, (0, 0, 0, 0, 0, pad))
    dtp, bp, cp = (F.pad(t, (0, 0, 0, pad)) for t in (dt, bm, cm))
    dyp = F.pad(dy, (0, 0, 0, 0, 0, pad))
    args = (xp, dtp, a, bp, cp)
    y, st = ssd.ssd_fwd(*args, return_states=True)
    y_only = ssd.ssd_fwd(*args)
    raw = ssd.ssd_bwd(*args, st, dyp)
    y_r, st_r = ref.ssd_fwd_ref(*args, chunk=ssd.CHUNK, return_states=True)
    raw_r = ref.ssd_bwd_ref(*args, st_r, dyp, chunk=ssd.CHUNK)
    args64 = [t.double() for t in args]
    y64, st64 = ref.ssd_fwd_ref(*args64, chunk=ssd.CHUNK,
                                return_states=True)
    raw64 = ref.ssd_bwd_ref(*args64, st64, dyp.double(), chunk=ssd.CHUNK)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    outs = {"y": (y, y_r, y64), "states": (st, st_r, st64)}
    outs.update({n: (k, p, d) for n, k, p, d in zip(
        ("dx", "ddt", "dda", "dbh", "dch"), raw, raw_r, raw64)})

    def tol(t):
        return TOL["bfloat16"] if t.dtype == torch.bfloat16 else SSD_TOL
    errs = {n: _row_err(k, p) for n, (k, p, _) in outs.items()}
    bad = {n: e for n, e in errs.items() if not e <= tol(outs[n][0])}
    # the whole function (padding, the autograd.Function, the chain rule
    # outside the kernel) against autograd of the plain forward in f64 on
    # the same inputs: each bf16 gradient is then one rounding (half an
    # ulp, <= 2**-8) from its f32 value, where two bf16 results could sit
    # a whole ulp apart. dA (H,) sums B S terms of both signs: 1e-4 of
    # max(1, max|dA|), as the CPU tests hold it.
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, bm, cm)]
    grads = torch.autograd.grad(ssd.ssd(*leaves), leaves, dy)

    def plain_grads(f64: bool):
        lv = [(t.double() if f64 else t).detach().requires_grad_(True)
              for t in (x, dt, a, bm, cm)]
        y_p = ref.ssd_fwd_ref(*(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                                if t.dim() > 1 else t for t in lv),
                              chunk=ssd.CHUNK)[:, :s]
        return torch.autograd.grad(y_p, lv, dy.to(y_p.dtype))
    g_plain, g64 = plain_grads(False), plain_grads(True)
    names = ("dx", "ddt", "dA", "dBm", "dCm")
    fn_errs = {n: _row_err(g, w) for n, g, w in zip(names, grads, g64)
               if n != "dA"}
    fn_plain = {n: _row_err(g, w) for n, g, w in zip(names, g_plain, g64)
                if n != "dA"}
    da_err = float((grads[2].double() - g64[2]).abs().max()
                   / max(1.0, float(g64[2].abs().max())))
    bad.update({"function " + n: e for n, e in fn_errs.items()
                if not e <= tol(x)})
    if not da_err <= 1e-4:
        bad["function dA vs f64"] = da_err
    bounds = _ssd_bounds(shape, dname)
    pass_rows, pass_timing = ssd_pass_rows(args, dyp, timed, bounds)
    bad.update({f"{name} {n}": e for name, r in pass_rows.items()
                for n, e in r["row_rel_err"].items()
                if not e <= r["tol"][n]})
    row = {"case": label, "shape": list(shape), "dtype": dname,
           "tol": {"float32": SSD_TOL, "bfloat16": TOL["bfloat16"]},
           "row_rel_err": errs,
           "vs_f64": {n: {"kernel": _row_err(k, d), "plain": _row_err(p, d)}
                      for n, (k, p, d) in outs.items()},
           "function_vs_f64": {"kernel": fn_errs, "plain": fn_plain},
           "function_dA_vs_f64": da_err,
           "max_abs_err": {n: _abs_err(k, p) for n, (k, p, _) in
                           outs.items()},
           "y_without_states_equal": bool(torch.equal(y, y_only)),
           "passes": pass_rows}
    if bad or not row["y_without_states_equal"]:
        log("parity", **row)
        raise AssertionError(f"SSD kernel disagrees with its plain version "
                             f"in {label}: {bad}, y without states equal "
                             f"{row['y_without_states_equal']}")
    if not timed:
        log("parity", **row)
        return None
    fns = {
        "ssd_fwd": (lambda: ssd.ssd_fwd(*args, return_states=True),
                    lambda: ref.ssd_fwd_ref(*args, chunk=ssd.CHUNK,
                                            return_states=True)),
        "ssd_bwd": (lambda: ssd.ssd_bwd(*args, st, dyp),
                    lambda: ref.ssd_bwd_ref(*args, st_r, dyp,
                                            chunk=ssd.CHUNK)),
    }
    timing = {}
    for name, (kern, plain_fn) in fns.items():
        # no single PyTorch call computes the SSD scan: library_ms null
        timing[name] = {"ms": cuda_time(kern, iters=10),
                        "plain_ms": cuda_time(plain_fn, iters=3),
                        "library_ms": None, **bounds[name],
                        "passes": {p: pass_timing[p]
                                   for p in SSD_PASSES[name]}}
    row["timing"] = timing
    log("parity", **row)
    abs_errs = {"ssd_fwd": max(row["max_abs_err"][n]
                               for n in ("y", "states")),
                "ssd_bwd": max(row["max_abs_err"][n] for n in
                               ("dx", "ddt", "dda", "dbh", "dch"))}
    return abs_errs, timing


def ssd_state_case(label, shape, dtype, timed):
    """The SSD forward from an initial state and with the final state, as
    a prefill continuing a cached state runs it: ``ssd_prefill`` (any S,
    padded with dt = 0 rows) against the plain version on the same padded
    inputs, each output also against an f64 evaluation; the state pass
    alone with both states against its plain version; and, from a zero
    initial state, y bitwise the training forward's (the null pointers).
    If ``timed``: kernel and plain times and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, ssd
    x, dt, a, bm, cm, _ = _ssd_inputs(shape, dtype, seed=2)
    b, s, h, p, n = shape
    L = ssd.CHUNK
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    init = torch.randn((b, h, p, n), generator=gen, device="cuda")
    pad = -s % L
    args = [F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), a,
            F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))]
    y, final = ssd.ssd_prefill(x, dt, a, bm, cm, init)
    y_r, f_r = ref.ssd_fwd_ref(*args, chunk=L, init_state=init,
                               return_final=True)
    y64, f64 = ref.ssd_fwd_ref(*(t.double() for t in args), chunk=L,
                               init_state=init.double(), return_final=True)
    st, fin = ssd.fwd_state(*args[:4], init_state=init, return_final=True)
    st_r, fin_r = ref.ssd_fwd_state_ref(*args[:4], chunk=L, init_state=init,
                                        return_final=True)
    y_zero, _ = ssd.ssd_prefill(x, dt, a, bm, cm, torch.zeros_like(init))
    y_train = ssd.ssd(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    outs = {"y": (y, y_r[:, :s], y64[:, :s]), "final": (final, f_r, f64),
            "fwd_state states": (st, st_r, None),
            "fwd_state final": (fin, fin_r, None)}

    def tol(t):
        return TOL["bfloat16"] if t.dtype == torch.bfloat16 else SSD_TOL
    errs = {k: _row_err(g, w) for k, (g, w, _) in outs.items()}
    bad = {k: e for k, e in errs.items() if not e <= tol(outs[k][0])}
    row = {"case": label, "state_in_out": True, "shape": list(shape),
           "dtype": dname, "tol": {"float32": SSD_TOL,
                                   "bfloat16": TOL["bfloat16"]},
           "row_rel_err": errs,
           "vs_f64": {k: {"kernel": _row_err(g, d), "plain": _row_err(w, d)}
                      for k, (g, w, d) in outs.items() if d is not None},
           "max_abs_err": {k: _abs_err(g, w)
                           for k, (g, w, _) in outs.items()},
           "chunk0_state_is_init": bool(torch.equal(st[:, :, 0], init)),
           "zero_init_y_equals_training": bool(torch.equal(y_zero,
                                                           y_train))}
    if bad or not (row["chunk0_state_is_init"]
                   and row["zero_init_y_equals_training"]):
        log("parity", **row)
        raise AssertionError(f"SSD with a state in and out disagrees in "
                             f"{label}: {bad}, {row}")
    if timed:
        row["timing"] = {
            "ms": cuda_time(lambda: ssd.ssd_prefill(x, dt, a, bm, cm, init),
                            iters=10),
            "plain_ms": cuda_time(lambda: ref.ssd_fwd_ref(
                *args, chunk=L, init_state=init, return_final=True), iters=3),
            "library_ms": None,
            **_ssd_bounds(shape, dname)["ssd_prefill"]}
    log("parity", **row)
    return row


def phase_parity():
    import numpy as np
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    rows = [parity_case("minicpm-2b", (1, 36, SEQ, 64), bf16, True, 0, True)]
    main = rows[0]
    rows.append(parity_case("qwen2-vl-2b", (1, 12, SEQ, 128), bf16, True, 0,
                            True))
    parity_case("ragged-f32", (1, 4, 1000, 128), f32, True, 0, False)
    parity_case("noncausal-f32", (2, 2, 320, 64), f32, False, 0, False)
    rows.append(parity_case("window", (1, 4, 1000, 64), bf16, True, 200,
                            False))
    # the bf16 tensor-core kernels at the edges the f32 cases hold the
    # scalar kernels to: a ragged S, no causal mask, a window
    for d in (64, 112, 128):
        rows.append(parity_case(f"ragged-bf16 D={d}", (1, 4, 1000, d), bf16,
                                True, 0, False))
    for d in (64, 112, 128):
        rows.append(parity_case(f"noncausal-bf16 D={d}", (2, 2, 320, d),
                                bf16, False, 0, False))
    for d in (112, 128):
        rows.append(parity_case(f"window D={d}", (1, 4, 1000, d), bf16,
                                True, 200, False))
    # the suffix prefill of a prefix-shared hit: the engine phase's
    # 1024-token system prefix, and ragged cases (an offset that is no
    # multiple of the 64-row tile) in f32 and bf16
    suffix_case("qwen2-vl-2b suffix prefill", 1, 12, 2048, SYSTEM_PREFIX,
                128, bf16)
    suffix_case("ragged suffix f32", 2, 4, 1000, 333, 64, f32)
    suffix_case("ragged suffix bf16 D=64", 2, 4, 1000, 333, 64, bf16)
    suffix_case("ragged suffix bf16 D=128", 2, 4, 1000, 333, 128, bf16)
    # decode: ragged lengths from a seed, including 1 and the full cache
    rng = np.random.default_rng(0)
    lens = [1, MAX_LEN] + rng.integers(1, MAX_LEN + 1, 6).tolist()
    dec = decode_case("minicpm-2b decode", 8, 36, 36, MAX_LEN, 64, bf16,
                      lens, True)
    lens = rng.permutation([1, MAX_LEN] + rng.integers(
        1, MAX_LEN + 1, 6).tolist()).tolist()
    dec_p = decode_case("qwen2-vl-2b paged decode", 8, 12, 2, MAX_LEN, 128,
                        bf16, lens, True)
    decode_case("length-0 slot", 4, 4, 2, 512, 128, f32, [0, 512, 77, 300],
                False)
    decode_case("ragged cache", 4, 8, 2, 1237, 64, f32, [1237, 1000, 613, 1],
                False, page_size=32)
    # one kv head, bf16, half the rows empty (the case whose per-row
    # error read NaN before the metric's floor skipped zero rows)
    decode_case("one kv head bf16", 2, 6, 1, 77, 64, bf16, [0, 77], False)
    # a slot's row alone and among other slots, linear and paged
    decode_invariance_case("qwen2-vl-2b", 12, 2, MAX_LEN, 128, bf16)
    decode_invariance_case("minicpm-2b", 36, 36, MAX_LEN, 64, bf16)
    # zamba2-7b: the shared block's attention (32 heads of 112) and the
    # SSD at one layer's shape (112 heads, P = N = 64); a ragged S at the
    # reduced config's P 128, N 16; bf16 inputs
    rows.append(parity_case("zamba2-7b shared block", (1, 32, SEQ, 112),
                            bf16, True, 0, True))
    parity_case("ragged-f32 D=112", (1, 4, 1000, 112), f32, True, 0, False)
    ssd_main = ssd_case("zamba2-7b", (1, SEQ, 112, 64, 64), f32, True)
    ssd_case("ragged S, P 128, N 16", (2, 1000, 4, 128, 16), f32, False)
    ssd_case("zamba2-7b bf16 inputs", (1, SEQ, 112, 64, 64), bf16, False)
    # hybrid serving: the SSD forward with a state in and out (a prefill
    # continuing a cached state) at one zamba2 layer and a ragged S; decode
    # at the shared block's head_dim 112, linear and paged, f32 and bf16
    ssd_prefill = ssd_state_case("zamba2-7b prefill", (1, 1024, 112, 64, 64),
                                 f32, True)
    ssd_state_case("ragged S, P 128, N 16", (2, 1000, 4, 128, 16), f32,
                   False)
    ssd_state_case("zamba2-7b prefill, bf16 inputs", (1, 1000, 112, 64, 64),
                   bf16, False)
    lens = rng.permutation([1, MAX_LEN] + rng.integers(
        1, MAX_LEN + 1, 6).tolist()).tolist()
    dec_z = decode_case("zamba2-7b shared-block decode", 8, 32, 32, MAX_LEN,
                        112, bf16, lens, True)
    decode_case("D=112 f32", 4, 32, 32, 1000, 112, f32, [0, 1000, 313, 1],
                False)
    decode_case("D=112 GQA 4:1 bf16", 3, 8, 2, 333, 112, bf16, [333, 1, 0],
                False, page_size=32)
    decode_invariance_case("zamba2-7b", 32, 32, MAX_LEN, 112, bf16)
    # stablelm-12b: 32 heads of 160 over 8 kv heads. Every attention case
    # head_dim 112 has, at 160: its layer's shape (timed), a ragged S, no
    # causal mask and a window in bf16 and f32, the query offset in both;
    # decode linear and paged in both (timed), a slot's row alone and
    # among 8 slots in both
    d160 = parity_case("stablelm-12b", (1, 32, SEQ, 160), bf16, True, 0,
                       True)
    rows.append(d160)
    for dt in (bf16, f32):
        name = str(dt).replace("torch.", "")
        for label, shape, causal, window in (
                ("ragged", (1, 4, 1000, 160), True, 0),
                ("noncausal", (2, 2, 320, 160), False, 0),
                ("window", (1, 4, 1000, 160), True, 200)):
            r = parity_case(f"{label}-{name} D=160", shape, dt, causal,
                            window, False)
            if dt == bf16:
                rows.append(r)
        suffix_case(f"ragged suffix {name} D=160", 2, 4, 1000, 333, 160, dt)
    lens = rng.permutation([1, MAX_LEN] + rng.integers(
        1, MAX_LEN + 1, 6).tolist()).tolist()
    dec_s = decode_case("stablelm-12b decode", 8, 32, 8, MAX_LEN, 160, bf16,
                        lens, True)
    dec_s32 = decode_case("D=160 f32", 4, 32, 8, 1000, 160, f32,
                          [0, 1000, 313, 1], True, page_size=32)
    decode_invariance_case("stablelm-12b", 32, 8, MAX_LEN, 160, bf16)
    decode_invariance_case("stablelm-12b f32", 32, 8, MAX_LEN, 160, f32)
    # glm4-9b's windowed decode (window 8192 = its ring's rows, 32 heads
    # over 2 kv heads of 128): two slots past the window, where every row
    # is valid, and one whose ring is partly filled (index + 1 < 8192),
    # where the reference's mask must keep just the prefix
    ring = ring_case("glm4-9b ring", 3, 32, 2, LONG_WINDOW, 128, bf16,
                     [LONG_WINDOW + 1024 + 63, 2 * LONG_WINDOW + 17, 5000],
                     LONG_WINDOW)
    # whisper-tiny: the cross-attention's decoder rows over the encoder's
    # 1500 (6 heads of 64, B 8, decoder seq 448), non-causal, forward and
    # backward, bf16 (timed) and f32; a ragged sq, and sq > sk; then the
    # cross-attention's decode over 1500 cached encoder rows
    cross = rect_case("whisper-tiny cross", 8, 6, 448, 1500, 64, bf16, True)
    rows.append(cross)
    rect_case("whisper-tiny cross f32", 8, 6, 448, 1500, 64, f32, False)
    rect_case("ragged cross f32", 2, 6, 37, 1500, 64, f32, False)
    rect_case("ragged cross bf16", 2, 6, 37, 1500, 64, bf16, False)
    rect_case("sq > sk f32", 2, 3, 300, 130, 64, f32, False)
    rect_case("sq > sk bf16", 2, 3, 300, 130, 64, bf16, False)
    dec_x = decode_case("whisper-tiny cross decode", 4, 6, 6, 1500, 64,
                        bf16, [1500] * 4, True)
    # flash_bwd_dq_mma_kernel enters dS = P (dP - delta) into dS K as one
    # bf16 operand
    log("parity", dq_ds_form="one bf16 operand", bf16_cases=len(rows),
        dq_row_rel_err_max=max(r["row_rel_err"]["flash_bwd_dq"]
                               for r in rows),
        function_row_rel_err_max=max(r["row_rel_err"]["function"]
                                     for r in rows),
        tol=TOL["bfloat16"])
    errs = dict(main["max_abs_err"], flash_decode=dec[0]["flash_decode"],
                flash_decode_paged=dec_p[0]["flash_decode_paged"],
                **ssd_main[0])
    timing = dict(main["timing"], flash_decode=dec[1]["flash_decode"],
                  flash_decode_paged=dec_p[1]["flash_decode_paged"],
                  **ssd_main[1])
    for name in ("flash_decode", "flash_decode_paged"):
        timing[name]["at_d112"] = dict(dec_z[1][name],
                                       max_abs_err=dec_z[0][name])
        timing[name]["at_d160"] = dict(dec_s[1][name],
                                       max_abs_err=dec_s[0][name])
        timing[name]["at_d160_f32"] = dict(dec_s32[1][name],
                                           max_abs_err=dec_s32[0][name])
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        timing[name]["at_d160"] = dict(d160["timing"][name],
                                       max_abs_err=d160["max_abs_err"][name])
        timing[name]["at_cross"] = dict(
            cross["timing"][name], q=cross["q"], kv=cross["kv"],
            max_abs_err=cross["max_abs_err"][name])
    timing["flash_decode"]["at_cross"] = dict(
        dec_x[1]["flash_decode"], max_abs_err=dec_x[0]["flash_decode"],
        shape=[4, 6, 6, 1500, 64], lengths=[1500] * 4)
    timing["flash_decode"]["ring"] = dict(
        ring["timing"], shape=ring["shape"], window=ring["window"],
        max_abs_err=ring["max_abs_err"])
    timing["ssd_fwd"]["with_state_in_out"] = dict(
        ssd_prefill["timing"], shape=ssd_prefill["shape"],
        max_abs_err=max(ssd_prefill["max_abs_err"].values()))
    return errs, timing


# ---------------------------------------------------------------------- #
# phase 3: solo run through the executor
# ---------------------------------------------------------------------- #
def _reset_all():
    from repro_torch.kernels import flash_attention, flash_decode, ssd
    flash_attention.reset_launches()
    flash_decode.reset_launches()
    ssd.reset_launches()


def _launches() -> dict:
    from repro_torch.kernels import flash_attention, flash_decode, ssd
    return {**flash_attention.LAUNCHES, **flash_decode.LAUNCHES,
            **ssd.LAUNCHES}


def _expect_launches(phase: str, expected: dict) -> dict:
    got = _launches()
    want = {k: expected.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{phase}: launches {got} != expected {want}")
    return got


def _expect(n_layers: int, micro: int) -> dict:
    # remat recomputes the forward in the backward: two forward launches
    return {"flash_fwd": 2 * n_layers * micro,
            "flash_bwd_dq": n_layers * micro,
            "flash_bwd_dkdv": n_layers * micro}


def _attention_calls(cfg) -> int:
    """Flash-attention calls in one forward: one a layer; for whisper
    each encoder layer's self-attention and each decoder layer's self-
    and cross-attention; none for xLSTM, which has no attention."""
    if cfg.family == "ssm":
        return 0
    if cfg.is_encoder_decoder:
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def _check_loss(phase: str, loss: float) -> None:
    if not math.isfinite(loss):
        raise AssertionError(f"{phase}: loss {loss} is not finite")


def phase_solo():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
    cfg = get_config("minicpm-2b")
    ex = ScheduleExecutor()
    spec = JobSpec(cfg, batch=BATCH, seq=SEQ, seed=0)
    ex.submit("minicpm", spec, steps=5)
    ex.start("minicpm", sub_batch=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
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
    launches = _expect_launches("solo", _expect(cfg.n_layers, micro))
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
    from repro_torch.launch.cluster import JobSpec
    cfg_a, cfg_b = get_config("minicpm-2b"), get_config("qwen2-vl-2b")
    s = 4                                    # sub-batch 1 at B = 4
    spec_a = JobSpec(cfg_a, batch=BATCH, accum_steps=s, seq=SEQ, seed=0)
    spec_b = JobSpec(cfg_b, batch=BATCH, accum_steps=s, seq=SEQ, seed=1)
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    r = measure_pair(spec_a, spec_b, iters=iters)
    # solo a, solo b, then the pair: each (iters + 1) steps incl. warm-up
    layer_micro = (iters + 1) * 2 * (cfg_a.n_layers * s + cfg_b.n_layers * s)
    launches = _expect_launches("pair", {
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
# phase 5: calibration at full depth
# ---------------------------------------------------------------------- #
@contextlib.contextmanager
def _step_times_recorded():
    """Keeps the per-step walltimes of every measurement made inside the
    block, in call order (``core.coschedule.step_times_recorded``, of
    which each measured mean is the mean), and beside each timed step
    what the host did inside it that a step does not always do: seconds
    in Python's garbage collector and the caching allocator's cudaMalloc
    calls. Yields (step times, causes) per measurement."""
    import gc
    import torch
    from repro_torch.core import coschedule
    gc_s, gc_start = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_start[0]

    def probe():
        return gc_s[0], torch.cuda.memory_stats().get("num_device_alloc")

    steps, causes = [], []
    gc.callbacks.append(on_gc)
    try:
        with coschedule.step_times_recorded(probe) as recorded:
            yield steps, causes
    finally:
        gc.callbacks.remove(on_gc)
        for times, probes in recorded:
            steps.append(times)
            causes.append([(g1 - g0, None if m0 is None else m1 - m0)
                           for (g0, m0), (g1, m1) in probes])


def _spread(steps) -> dict:
    times = sorted(steps)
    return {"mean": sum(times) / len(times), "min": times[0],
            "median": times[len(times) // 2], "max": times[-1],
            "max_over_min": times[-1] / times[0], "steps": list(steps)}


def _calibration_launches(specs, pairs, iters: int) -> dict:
    """Each measurement is ``iters`` + 1 steps (the warm-up included) at
    accum 1: one micro-batch a step and member. The sweep walks the
    candidate sub-batches of B."""
    from repro_torch.core.batch_scaling import candidate_sub_batches
    layers = sum(len(candidate_sub_batches(s.batch)) * s.cfg.n_layers
                 for s in specs.values())
    layers += sum(specs[a].cfg.n_layers + specs[b].cfg.n_layers
                  for a, b in pairs)
    return _expect(layers * (iters + 1), 1)


def _check_calibration(phase, payload, recorded, pairs) -> list:
    """Every time finite and positive, beta > 0, xi > 1; each
    measurement's step spread, and each xi beside the range its steps
    give. ``recorded`` is ``_step_times_recorded``'s (step times, causes)
    in measurement order: each arch's sweep, then each pair."""
    steps, causes = recorded
    rows = []
    i = 0
    solo_steps = {}
    for name, entry in payload["archs"].items():
        pts = entry["sweep"]["sub_batches"]
        for b, t in zip(pts, entry["sweep"]["times"]):
            sp = _spread(steps[i])
            if not (math.isfinite(t) and t > 0) or abs(sp["mean"] - t) > \
                    1e-9 * t:
                raise AssertionError(f"{phase}: {name} b={b}: {t}, {sp}")
            rows.append({"arch": entry["arch"], "sub_batch": b, **sp})
            if b == entry["batch"]:
                solo_steps[name] = steps[i]
            i += 1
        if not entry["beta_comp"] > 0:
            raise AssertionError(f"{phase}: {name} beta "
                                 f"{entry['beta_comp']} <= 0")
    for a, b in pairs:
        entry = payload["pairs"][f"{a}+{b}"]
        sp = _spread(steps[i])
        i += 1
        for key in ("t_a_solo", "t_b_solo", "t_pair", "xi_a", "xi_b"):
            if not (math.isfinite(entry[key]) and entry[key] > 0):
                raise AssertionError(f"{phase}: {a}+{b} {key} {entry[key]}")
        if not (entry["xi_a"] > 1 and entry["xi_b"] > 1):
            raise AssertionError(f"{phase}: {a}+{b} xi "
                                 f"{entry['xi_a']}, {entry['xi_b']} <= 1")
        rows.append({"pair": f"{a}+{b}", **sp,
                     "xi_a": entry["xi_a"], "xi_b": entry["xi_b"],
                     "xi_a_range": [sp["min"] / max(solo_steps[a]),
                                    sp["max"] / min(solo_steps[a])],
                     "xi_b_range": [sp["min"] / max(solo_steps[b]),
                                    sp["max"] / min(solo_steps[b])],
                     "xi_a_structural": entry["xi_a_structural"],
                     "xi_b_structural": entry["xi_b_structural"]})
    if i != len(steps):
        raise AssertionError(f"{phase}: {len(steps)} measurements, "
                             f"expected {i}")
    for row, cause in zip(rows, causes):
        row["spread_over_1.15"] = row["max_over_min"] > 1.15
        row["gc_s"] = [c[0] for c in cause]
        row["cuda_mallocs"] = [c[1] for c in cause]
        log(phase, **row)
    return rows


# Timed steps a measurement. With 3, single host outliers of 1.4-1.8x
# the median spoiled some means on the card (PERF.md §6).
CAL_ITERS = 6


def phase_calibrate(iters: int = CAL_ITERS):
    """``run_calibration`` on minicpm-2b and qwen2-vl-2b at full width and
    depth, bf16, seq 2048, B = 4 at accum 1, sweep points 4, 2, 1; the
    cross pair and qwen2-vl-2b with itself. Writes the artifact and reads
    it back through the port's readers."""
    import torch
    from repro_torch.core.calibration import (load_artifact,
                                              perf_params_from_artifact,
                                              run_calibration,
                                              save_artifact)
    from repro_torch.core.interference import InterferenceModel
    from repro_torch.launch.calibrate import CALIBRATION_PATH, build_specs
    t_phase = time.perf_counter()
    specs = build_specs(("minicpm-2b", "qwen2-vl-2b"), batch=BATCH, seq=SEQ)
    pairs = [("minicpm-2b", "qwen2-vl-2b"), ("qwen2-vl-2b", "qwen2-vl-2b")]
    log("calibrate", left_out="minicpm-2b+minicpm-2b",
        reason="two full-width minicpm-2b states with one step's "
               "transients reckon at ~82 GB at b = 4, over the 80 GB card")
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    with _step_times_recorded() as recorded:
        payload = run_calibration(specs, iters=iters, pairs=pairs)
    launches = _expect_launches(
        "calibrate", _calibration_launches(specs, pairs, iters))
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check_calibration("calibrate", payload, recorded, pairs)
    path = save_artifact(payload, CALIBRATION_PATH)
    loaded = load_artifact(path)
    if loaded != json.loads(json.dumps(payload)):
        raise AssertionError("calibrate: the artifact did not read back")
    model = InterferenceModel.from_artifact(path)
    for name, entry in loaded["archs"].items():
        p = perf_params_from_artifact(entry)
        log("calibrate", arch=entry["arch"], alpha=p.alpha_comp,
            beta=p.beta_comp, t_iter_solo=entry["t_iter_solo"],
            t_iter_b4_from_fit=p.t_iter(entry["batch"]),
            n_params=entry["n_params"])
    for key, entry in loaded["pairs"].items():
        xi = (model.xi(entry["a"], entry["b"]),
              model.xi(entry["b"], entry["a"]))
        if xi != (entry["xi_a"], entry["xi_b"]):
            raise AssertionError(f"calibrate: {key} table {xi}")
        log("calibrate", pair=key, xi_a=xi[0], xi_b=xi[1],
            xi_a_structural=entry["xi_a_structural"],
            xi_b_structural=entry["xi_b_structural"])
    log("calibrate", summary=True, host=loaded["host"], iters=iters,
        artifact=os.path.relpath(path, ROOT), launches=launches,
        max_memory_allocated_gb=peak,
        seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------- #
# phase 6: the simulated schedule, replayed
# ---------------------------------------------------------------------- #
# the replay's jobs at a quarter of each arch's layers, full width (the
# CLI's full-width default is half: 20 / 14 layers, ~80 s of the smoke);
# its calibration runs at full depth in phase calibrate, the executor in
# phase solo
REPLAY_DEPTH = 0.25


def phase_replay(iters: int = CAL_ITERS, iters_a: int = 24):
    """The replay scenario (``launch.replay``) on minicpm-2b at 10 of 40
    layers and qwen2-vl-2b at 7 of 28, full width, bf16, seq 2048,
    B = 4: its own calibration (every pair), the SJF-BSBF schedule on it,
    the plan executed, and each job re-run solo."""
    import torch
    from repro_torch.core.calibration import run_calibration
    from repro_torch.launch import replay
    from repro_torch.launch.calibrate import build_specs
    from repro_torch.launch.cluster import accum_for_sub_batch
    t_phase = time.perf_counter()
    specs = build_specs((replay.ARCH_A, replay.ARCH_B), batch=BATCH,
                        seq=SEQ, depth_fraction=REPLAY_DEPTH)
    layers = {n: s.cfg.n_layers for n, s in specs.items()}
    if layers != {"minicpm-2b": 10, "qwen2-vl-2b": 7}:
        raise AssertionError(f"replay: layers {layers}")
    log("replay", configs={n: s.cfg.name for n, s in specs.items()},
        reduced="depth 40 -> 10 (minicpm-2b), 28 -> 7 (qwen2-vl-2b); "
                "widths as published", seq=SEQ, batch=BATCH)
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    with _step_times_recorded() as recorded:
        payload = run_calibration(specs, iters=iters)
    pairs = [(e["a"], e["b"]) for e in payload["pairs"].values()]
    cal_launches = _expect_launches(
        "replay calibration", _calibration_launches(specs, pairs, iters))
    _check_calibration("replay", payload, recorded, pairs)

    sim, res, plan = replay.simulate(payload, iters_a=iters_a)
    max_group, reconfigs = replay._structure(sim.log)
    subs_a = [r["sub_batch"] for r in reconfigs if r["jid"] == 0]
    batch_a = sim.jobs[0].batch
    if max_group < 3:
        raise AssertionError(f"replay: largest sharing group {max_group}")
    if len(subs_a) < 2 or subs_a[0] >= batch_a or subs_a[-1] != batch_a:
        raise AssertionError(f"replay: A's reconfigs {subs_a}")
    jobs = replay.job_specs(sim, specs)
    totals = {}
    for phase in plan.phases:
        for name, q in phase.quotas:
            totals[name] = totals.get(name, 0) + q
    if totals != {n: steps_ for n, (_, steps_) in jobs.items()}:
        raise AssertionError(f"replay: quotas {totals}")
    log("replay", plan=[{"ops": [[op.kind, op.job, op.sub_batch]
                                 for op in phase.ops],
                         "quotas": dict(phase.quotas),
                         "groups": phase.groups,
                         "sim_duration": phase.sim_duration}
                        for phase in plan.phases],
        predicted=plan.predicted)

    _reset_all()
    ex, report = replay.execute(plan, jobs, device="cuda")
    starts = replay.start_sub_batches(plan)
    layer_micro = 0
    for name, (spec, steps_) in jobs.items():
        if report[name]["steps"] != steps_:
            raise AssertionError(f"replay: {name} took "
                                 f"{report[name]['steps']} of {steps_}")
        _check_loss("replay", report[name]["loss"])
        layer_micro += spec.cfg.n_layers * sum(
            accum_for_sub_batch(spec.batch, sub)
            for sub in replay.step_sub_batches(
                starts[name], ex.runs[name].reconfigs, steps_))
    exec_launches = _expect_launches("replay", _expect(layer_micro, 1))
    peak = torch.cuda.max_memory_allocated() / 1e9

    _reset_all()
    same = replay.solo_equal(ex, plan, jobs, device="cuda")
    solo_launches = _expect_launches("replay solo", _expect(layer_micro, 1))
    out = replay.summarize(sim, res, plan, report, payload, same)
    for name, row in out["jobs"].items():
        log("replay", job=name, **row, solo_rerun_equal=same[name])
    log("replay", summary=True, **out["summary"], **out["structure"],
        launches={"calibration": cal_launches, "execute": exec_launches,
                  "solo_reruns": solo_launches},
        max_memory_allocated_gb=peak,
        seconds=time.perf_counter() - t_phase)
    if not all(same.values()):
        raise AssertionError(f"replay: sharing changed training {same}")
    del ex
    torch.cuda.empty_cache()
    return {"calibration": cal_launches, "execute": exec_launches,
            "solo_reruns": solo_launches}


# ---------------------------------------------------------------------- #
# phase 6b: every policy on the card's profiles, the paper's traces and a
# datacenter
# ---------------------------------------------------------------------- #
DECISIONS = ("scalar", "grid", "batched")
# the top point of the reference's ``benchmarks/sim_scale.py`` ladder
# (LADDER_JOBS[1024]): 1024 GPUs as 128 servers of 8, at 5000 of its 20000
# jobs (the smoke's time; the three decision paths' logs still compared)
PHILLY_GPUS, PHILLY_JOBS, PHILLY_PER_SERVER = 1024, 5000, 8


def _policy_row(res, seconds) -> dict:
    s = res.summary()
    return {"avg_jct": s["avg_jct"], "avg_queue": s["avg_queue"],
            "makespan": s["makespan"], "avg_jct_large": s["avg_jct_large"],
            "avg_jct_small": s["avg_jct_small"],
            "preemptions": sum(j.preemptions for j in res.jobs),
            "events": res.events, "seconds": seconds}


def _all_finished(phase: str, what: str, res, n_jobs: int) -> None:
    done = [j for j in res.jobs if j.finish_time is not None]
    if len(res.jobs) != n_jobs or len(done) != n_jobs:
        raise AssertionError(f"{phase}: {what}: {len(done)} of {n_jobs} "
                             "jobs finished")


def _same_log(phase: str, what: str, log, want) -> None:
    if log != want:
        first = next((i for i, (a, b) in enumerate(zip(log, want))
                      if a != b), min(len(log), len(want)))
        raise AssertionError(
            f"{phase}: {what}: logs part at record {first} "
            f"({log[first:first + 1]} vs {want[first:first + 1]})")


def _heap_matches_scan(phase: str, what: str, heap, scan) -> None:
    """The reference's own yardstick for its two engines: the same
    records in the same order, times and finish times within rel 1e-6
    (the scan engine accrues every job at every event)."""
    (hsim, hres), (ssim, sres) = heap, scan
    if ([e[1:] for e in hsim.log] != [e[1:] for e in ssim.log]
            or hres.events != sres.events):
        raise AssertionError(f"{phase}: {what}: heap and scan records")
    for a, b in [(e[0], f[0]) for e, f in zip(hsim.log, ssim.log)] + [
            (j.finish_time, ssim.jobs[j.jid].finish_time)
            for j in hres.jobs]:
        if abs(a - b) > 1e-6 * max(abs(a), abs(b)):
            raise AssertionError(f"{phase}: {what}: heap {a} vs scan {b}")


def phase_policies():
    """The paper's comparison of all seven policies, on the host: (a) the
    calibrated mode of ``table2_physical`` over the profiles and xi that
    the calibrate phase measured on this card; (b) the paper's traces
    (Table II's physical trace, Tables III-IV's 240 and 480 jobs) under
    its interference model; (c) a Philly-shaped trace at 1024 GPUs.
    Gated: every job finishes, a second run gives the same log, heap ==
    scan, SJF-BSBF's grid == batched == scalar."""
    import copy
    from repro_torch.core import (ClusterState, Simulator, load_artifact,
                                  make_scheduler, paper_interference_model,
                                  philly_trace, physical_trace,
                                  simulation_trace)
    from repro_torch.launch import cluster_scheduling as cs
    from repro_torch.launch.calibrate import CALIBRATION_PATH
    t_phase = time.perf_counter()
    card = nvidia_smi()

    # (a) Table II on the card's own calibration
    cal = load_artifact(CALIBRATION_PATH)
    log("policies", part="table2-calibrated",
        artifact=os.path.relpath(CALIBRATION_PATH, ROOT),
        measured_on=cal.get("host", {}).get("kind"), card=card, n_jobs=30,
        cluster="2 x 2 GPUs",
        capacity_gb=cs.calibrated_capacity(cal) / 2 ** 30)
    first = cs.calibrated_run(cal)
    again = cs.calibrated_run(cal)
    for policy, r in first.items():
        _all_finished("policies", f"calibrated {policy}", r["res"], 30)
        _same_log("policies", f"calibrated {policy} rerun",
                  again[policy]["sim"].log, r["sim"].log)
        log("policies", part="table2-calibrated", policy=policy,
            **_policy_row(r["res"], r["seconds"]))
    for d in DECISIONS[1:]:
        other = cs.calibrated_run(cal, policies=("sjf-bsbf",), decision=d)
        _same_log("policies", f"calibrated sjf-bsbf {d}",
                  other["sjf-bsbf"]["sim"].log, first["sjf-bsbf"]["sim"].log)
    log("policies", part="table2-calibrated", card=card,
        **cs.headline(first))

    # (b) the paper's traces, its interference model
    paper = (("table2-physical", physical_trace(seed=0), 4, 4),
             ("table3-240", simulation_trace(240), 16, 4),
             ("table4-480", simulation_trace(480), 16, 4))
    for part, jobs, servers, per in paper:
        heap = cs.run_policies(jobs, cs.ALL_SEVEN, n_servers=servers,
                               gpus_per_server=per)
        scan = cs.run_policies(jobs, cs.ALL_SEVEN, n_servers=servers,
                               gpus_per_server=per, engine="scan")
        for policy in cs.ALL_SEVEN:
            h, sc = heap[policy], scan[policy]
            _all_finished("policies", f"{part} {policy}", h["res"],
                          len(jobs))
            _heap_matches_scan("policies", f"{part} {policy}",
                               (h["sim"], h["res"]), (sc["sim"], sc["res"]))
            log("policies", part=part, policy=policy,
                scan_seconds=sc["seconds"], **_policy_row(h["res"],
                                                          h["seconds"]))
        for d in DECISIONS[1:]:
            other = cs.run_policies(jobs, ("sjf-bsbf",), n_servers=servers,
                                    gpus_per_server=per, decision=d)
            _same_log("policies", f"{part} sjf-bsbf {d}",
                      other["sjf-bsbf"]["sim"].log,
                      heap["sjf-bsbf"]["sim"].log)
        log("policies", part=part, n_jobs=len(jobs),
            cluster=f"{servers} x {per} GPUs", card=card,
            **cs.headline(heap))

    # (c) datacenter scale: the three decision paths' logs equal
    jobs = philly_trace(n_jobs=PHILLY_JOBS, seed=0, n_gpus=PHILLY_GPUS)
    log("policies", part="philly-1024", n_jobs=PHILLY_JOBS,
        cluster=f"{PHILLY_GPUS // PHILLY_PER_SERVER} x {PHILLY_PER_SERVER}"
                " GPUs, 11 GB", card=card)
    for policy in ("sjf", "sjf-bsbf"):
        logs = {}
        for d in DECISIONS:
            cluster = ClusterState(PHILLY_GPUS // PHILLY_PER_SERVER,
                                   PHILLY_PER_SERVER,
                                   gpu_capacity_bytes=11 * 2 ** 30)
            sim = Simulator(cluster, copy.deepcopy(jobs),
                            make_scheduler(policy),
                            interference=paper_interference_model(),
                            decision=d)
            t0 = time.perf_counter()
            res = sim.run()
            seconds = time.perf_counter() - t0
            _all_finished("policies", f"philly {policy} {d}", res,
                          PHILLY_JOBS)
            logs[d] = sim.log
            log("policies", part="philly-1024", policy=policy, decision=d,
                events=res.events, seconds=seconds,
                events_per_second=res.events / seconds,
                avg_jct=res.avg_jct(), avg_queue=res.avg_queueing(),
                makespan=res.makespan)
        for d in DECISIONS[1:]:
            _same_log("policies", f"philly {policy} {d}", logs[d],
                      logs["scalar"])
    log("policies", card=card, seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------- #
# phase 7: checkpoints, fault recovery and segment retry
# ---------------------------------------------------------------------- #
# minicpm-2b at 2 of its 40 layers (qwen2-vl-2b at 2 of 28), full width:
# one checkpoint of the bf16 params and f32 moments is 4.05 GB (2.83 GB
# of it the tied embedding), where 4 layers' was 5.27 GB and the full
# depth's is 27.25 GB. The phase is its checkpoints' I/O: three writes, a
# restart's read and a CRC read.
RECOVERY_LAYERS = 2
# steps a recovery run takes: the fault at call 4 comes after the step-2
# and step-4 checkpoints, and the restarted run writes no third one
RECOVERY_STEPS = 5


def _recovery_specs():
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.cluster import JobSpec
    specs = {}
    for i, name in enumerate(("minicpm-2b", "qwen2-vl-2b")):
        cfg = get_config(name)
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}@{RECOVERY_LAYERS}",
                                  n_layers=RECOVERY_LAYERS)
        specs[name] = JobSpec(cfg, batch=BATCH, seq=SEQ, seed=i)
    return specs


def _checkpoint_dir(need_bytes: int) -> str:
    """A fresh directory under the temporary directory, which must have
    ``need_bytes`` free."""
    import shutil
    import tempfile
    free = shutil.disk_usage(tempfile.gettempdir()).free
    if free < need_bytes:
        raise RuntimeError(
            f"recovery: checkpoints need {need_bytes / 1e9:.1f} GB free in "
            f"{tempfile.gettempdir()}, which has {free / 1e9:.1f} GB")
    return tempfile.mkdtemp(prefix="chip_smoke_ckpt_")


def _bitwise(run, base) -> dict:
    """Which parts of ``run``'s state are bitwise ``base``'s."""
    import torch
    from repro_torch.tree import flatten

    def same(a, b):
        fa, fb = flatten(a), flatten(b)
        return sorted(fa) == sorted(fb) and all(
            torch.equal(fa[k], fb[k]) for k in fa)
    out = {"params": same(run.params, base.params)}
    if run.opt is not None:
        out.update(m=same(run.opt.m, base.opt.m),
                   v=same(run.opt.v, base.opt.v),
                   step=run.opt.step == base.opt.step,
                   loss=torch.equal(run.last_metrics["loss"],
                                    base.last_metrics["loss"]))
    return out


def _require(phase: str, what: str, same: dict) -> None:
    if not all(same.values()):
        raise AssertionError(f"{phase}: {what} not bitwise: {same}")


def _recovery_training(specs, ckdir):
    """(a)-(d) and the checkpoint measurements; returns (layer-steps run,
    measurements)."""
    import os
    import torch
    from repro_torch.checkpoint import checkpoint_crc
    from repro_torch.checkpoint.npz import _content_crc, _read
    from repro_torch.launch.cluster import (FaultSpec, PlanOp, PlanPhase,
                                            ScheduleExecutor,
                                            ScriptedFaults)
    spec_a, spec_b = specs["minicpm-2b"], specs["qwen2-vl-2b"]
    la, lb = spec_a.cfg.n_layers, spec_b.cfg.n_layers
    n = RECOVERY_STEPS
    out = {}

    base = ScheduleExecutor()
    base.submit("a", spec_a, n)
    base.start("a")
    t_plain = [base.step_group(["a"])["walltime"] for _ in range(n)]
    ref = base.runs["a"]
    layer_steps = la * base.calls

    # (a) fatal fault at call 4, checkpoints every 2 steps, restart. The
    # step-2 write runs on the writer thread during steps 3 and 4, which
    # are timed against the uninterrupted run's steps 3 and 4.
    ex = ScheduleExecutor(checkpoint_dir=ckdir, checkpoint_every=2,
                          fault_injector=ScriptedFaults(
                              [FaultSpec(call=4, job="a", kind="fatal")]))
    ex.submit("a", spec_a, n)
    ex.start("a")
    t_ex = []
    for _ in range(4):
        res = ex.step_group(["a"])
        if "dropped" in res:
            raise AssertionError("recovery: dropped before the fault")
        t_ex.append(res["walltime"])
    in_flight = ex.checkpoints_written == 0
    if ex.step_group(["a"]).get("dropped") != "a":
        raise AssertionError("recovery: the fatal fault did not drop")
    run = ex.runs["a"]
    if not run.failed or run.last_ckpt_step != 4:
        raise AssertionError(f"recovery: failed {run.failed}, last "
                             f"checkpoint {run.last_ckpt_step}")
    t0 = time.perf_counter()
    ex.restart("a")
    out["restart_s"] = time.perf_counter() - t0
    if run.steps_done != 4 or ex.checkpoints_written != 2:
        raise AssertionError(f"recovery: restart at {run.steps_done}, "
                             f"{ex.checkpoints_written} checkpoints")
    while run.steps_done < n:
        ex.step_group(["a"])
    same = _bitwise(run, ref)
    _require("recovery (a) restart", f"step {n}", same)
    ex.close()
    if ex.calls != n:
        raise AssertionError(f"recovery: {ex.calls} calls in (a)")
    layer_steps += la * ex.calls
    path = os.path.join(ckdir, "a.npz")
    stored = checkpoint_crc(path)
    t0 = time.perf_counter()
    recomputed = _content_crc({k: v for k, v in _read(path).items()
                               if k != "__crc32__"})
    t_recompute = time.perf_counter() - t0
    out.update(
        restart_bitwise=same, checkpoints_written=ex.checkpoints_written,
        checkpoint_bytes=os.path.getsize(path),
        checkpoint_snapshot_s=[c[0] for c in ex.checkpoint_seconds],
        checkpoint_write_s=[c[1] for c in ex.checkpoint_seconds],
        crc_stored=stored, crc_recomputed=recomputed,
        crc_recompute_from_file_s=t_recompute,
        step_s_plain=t_plain, step_s_run_a=t_ex,
        step_s_no_write=t_plain[2:4], step_s_write_in_flight=t_ex[2:4],
        write_in_flight_through_steps_3_4=in_flight)
    if stored != recomputed:
        raise AssertionError(f"recovery: stored CRC {stored:#010x} != "
                             f"recomputed {recomputed:#010x}")
    del ex, run

    # (b) a transient fault, retried once: the same bits as no fault
    ex = ScheduleExecutor(fault_injector=ScriptedFaults(
        [FaultSpec(call=2, job="a")]))
    ex.submit("a", spec_a, n)
    ex.start("a")
    for _ in range(n):
        if "dropped" in ex.step_group(["a"]):
            raise AssertionError("recovery (b): dropped")
    if ex.runs["a"].retries != 1 or ex.retries_total != 1:
        raise AssertionError(f"recovery (b): {ex.retries_total} retries")
    same = _bitwise(ex.runs["a"], ref)
    _require("recovery (b) retry", "the retried run", same)
    out["retry_bitwise"] = same
    layer_steps += la * ex.calls
    del ex

    # (c) the pair: a fatal fault drops qwen2-vl-2b only
    ex = ScheduleExecutor(fault_injector=ScriptedFaults(
        [FaultSpec(call=2, job="b", kind="fatal")]))
    for name, spec in (("a", spec_a), ("b", spec_b)):
        ex.submit(name, spec, n)
        ex.start(name)
    for _ in range(2):
        ex.step_group(["a", "b"])
    if ex.step_group(["a", "b"]).get("dropped") != "b":
        raise AssertionError("recovery (c): b was not dropped")
    while ex.runs["a"].steps_done < n:
        ex.step_group(["a"])
    same = _bitwise(ex.runs["a"], ref)
    _require("recovery (c) pair", "the survivor", same)
    out["pair_survivor_bitwise"] = same
    layer_steps += la * ex.runs["a"].steps_done + lb * ex.runs["b"].steps_done
    del ex

    # (d) a one-phase plan through execute, the fault in the middle
    ex = ScheduleExecutor(fault_injector=ScriptedFaults(
        [FaultSpec(call=n // 2, job="b", kind="fatal")]))
    ex.submit("a", spec_a, n)
    ex.submit("b", spec_b, n)
    report = ex.execute([PlanPhase(
        ops=(PlanOp("start", "a"), PlanOp("start", "b")),
        quotas=(("a", n), ("b", n)), groups=(("a", "b"),))])
    if (report["a"]["steps"], report["a"]["failed"], report["b"]["steps"],
            report["b"]["failed"]) != (n, False, n // 2, True):
        raise AssertionError(f"recovery (d): report {report}")
    same = _bitwise(ex.runs["a"], ref)
    _require("recovery (d) execute", "the survivor", same)
    out["plan_survivor_bitwise"] = same
    out["plan_report"] = {k: {f: v[f] for f in ("steps", "failed", "walltime")}
                          for k, v in report.items()}
    layer_steps += la * n + lb * (n // 2)
    del ex, base, ref
    torch.cuda.empty_cache()
    return layer_steps, out


def _engine_retry() -> dict:
    """The reduced f32 qwen2-vl-2b engine (``_engine_small``'s config),
    dense and paged, with a scripted transient fault before segment 1:
    its tokens must be the fault-free run's and ``stats["retries"]`` 1;
    a budget that runs out raises ``TransientFault``. Returns the faulted
    runs' launches."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.cluster import (FaultSpec, ScriptedFaults,
                                            TransientFault)
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.models import init_params
    from repro_torch.util.retry import RetryPolicy
    cfg = dataclasses.replace(get_config("qwen2-vl-2b").reduced(),
                              dtype="float32")
    params = init_params(cfg, 2)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab, int(rng.integers(20, 60))),
             int(rng.integers(8, 25))) for _ in range(8)]
    kw = dict(n_slots=4, max_len=128, segment=8)
    launches = {}
    for way, extra in (("dense", {}),
                       ("paged", {"paged": True, "page_size": 16})):
        expect = _engine_launches(cfg, 8, len(reqs), extra.get("paged"))
        want, st0, _, _ = _run_engine(cfg, params, reqs, expect, **kw,
                                      **extra)
        got, st, launches[f"engine_retried_{way}"], _ = _run_engine(
            cfg, params, reqs, expect, **kw, **extra,
            fault_injector=ScriptedFaults([FaultSpec(call=1,
                                                     job="segment")]),
            retry_policy=RetryPolicy(attempts=3, base=0.0))
        row = {"way": way, "tokens_vs_fault_free": _agreement(got, want),
               "retries": st["retries"], "segments": st["segments"],
               "segments_fault_free": st0["segments"]}
        log("recovery", engine=True, **row)
        if (got != want or st["retries"] != 1
                or st["segments"] != st0["segments"]):
            raise AssertionError(f"recovery: engine retry {row}")
    eng = DecodeEngine(cfg, params, **kw, fault_injector=ScriptedFaults(
        [FaultSpec(call=1, job="segment", times=2)]),
        retry_policy=RetryPolicy(attempts=2, base=0.0))
    for p, n in reqs:
        eng.submit(p, n)
    try:
        eng.run()
    except TransientFault:
        log("recovery", engine=True, exhausted_budget_raised="TransientFault")
    else:
        raise AssertionError("recovery: an exhausted segment retry did "
                             "not raise")
    return launches


def phase_recovery():
    """minicpm-2b at 2 of 40 layers (and qwen2-vl-2b at 2 of 28), full
    width, bf16, seq 2048, B = 4 through the executor's fault paths:
    (a) fail at call 4, restart from the step-4 checkpoint, step 5
    bitwise the uninterrupted run's; (b) a transient retried once, bitwise
    no fault; (c) a pair whose qwen2-vl-2b is dropped, the survivor
    bitwise its solo run; (d) the same through ``execute``. Then the
    checkpoint's bytes, write seconds and CRC, the step with and without a
    write in flight, and the engine's segment retry."""
    import resource
    import shutil
    import torch
    from repro_torch.models import init_params, param_count
    t_phase = time.perf_counter()
    specs = _recovery_specs()
    n_params = param_count(init_params(specs["minicpm-2b"].cfg, 0,
                                       device="meta"))
    # bf16 params, f32 m and v
    reckoned = n_params * (2 + 4 + 4)
    # an overwrite holds the tmp file and the old one for a moment
    ckdir = _checkpoint_dir(2 * reckoned + (1 << 30))
    log("recovery", configs={n: s.cfg.name for n, s in specs.items()},
        reduced=f"depth 40 -> {RECOVERY_LAYERS} (minicpm-2b), 28 -> "
                f"{RECOVERY_LAYERS} (qwen2-vl-2b), for the checkpoint's "
                f"size; widths as published",
        seq=specs["minicpm-2b"].seq, batch=specs["minicpm-2b"].batch,
        params=n_params,
        reckoned_checkpoint_gb=reckoned / 1e9, checkpoint_dir=ckdir,
        free_gb=shutil.disk_usage(ckdir).free / 1e9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    try:
        layer_steps, out = _recovery_training(specs, ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    launches = {"training": _expect_launches("recovery",
                                             _expect(layer_steps, 1))}
    log("recovery", **out, layer_steps=layer_steps,
        launches=launches["training"],
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        host_max_rss_gb=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6)
    launches.update(_engine_retry())
    log("recovery", seconds=time.perf_counter() - t_phase)
    return launches


# ---------------------------------------------------------------------- #
# phase 8: the training driver and the quickstart
# ---------------------------------------------------------------------- #
QUICKSTART_STEPS = 60
TRAIN_ARGS = ["--arch", "minicpm-2b", "--dtype", "bfloat16", "--batch",
              str(BATCH), "--seq", str(SEQ), "--accum-steps", "2",
              "--steps", "3", "--log-every", "1"]
# launch.train's runs (phases train and sharded) at 2 of minicpm-2b's 40
# layers, full width, as phase recovery's: the checkpoint, bf16
# parameters and two f32 moments at 10 bytes a parameter, is 4.05 GB there
# against 27.25 GB at full depth (written and CRC'd twice, ~40 s each).
# Full depth trains in phases solo, pair and calibrate.
TRAIN_LAYERS = 2
# the room launch.train's checkpoint needs, with some to spare
TRAIN_CKPT_BYTES = 8 * 10 ** 9


@contextlib.contextmanager
def _train_depth(n_layers: int = TRAIN_LAYERS):
    """``launch.train`` inside the block trains its arch at ``n_layers``
    layers, full width (named ``arch@n``): its config lookup is replaced
    for the block. Its flags are the reference's, which has no depth
    flag."""
    import dataclasses
    from repro_torch.launch import train
    lookup = train.get_config

    def cut(name):
        cfg = lookup(name)
        return dataclasses.replace(cfg, name=f"{cfg.name}@{n_layers}",
                                   n_layers=n_layers)
    train.get_config = cut
    try:
        yield cut
    finally:
        train.get_config = lookup


def phase_train():
    """``launch.quickstart`` for 60 steps (the shrunk f32 minicpm-2b,
    structured batches, accum 2): the loss must fall. Then
    ``launch.train`` on minicpm-2b at full width and ``TRAIN_LAYERS`` of
    its layers, bf16, B = 4, seq 2048, accum 2, 3 steps, with a
    checkpoint: a finite loss and exact flash launch counts. Returns the
    launches and that run's per-step losses, checkpoint CRC, seconds a
    step and peak memory, which phase ``sharded`` holds its run against."""
    import shutil
    import torch
    from repro_torch.checkpoint import checkpoint_crc
    from repro_torch.launch import quickstart, train
    t_phase = time.perf_counter()
    launches = {}
    cfg = quickstart.shrunk_config()
    _reset_all()
    t0 = time.perf_counter()
    losses = quickstart.run(cfg, steps=QUICKSTART_STEPS, batch=4, seq=128,
                            accum_steps=2, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["quickstart"] = _expect_launches(
        "train quickstart", _expect(cfg.n_layers, QUICKSTART_STEPS * 2))
    first, last = quickstart.check_falls(losses)
    log("train", run="quickstart", model=f"{cfg.name} shrunk",
        n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
        dtype=cfg.dtype, steps=len(losses), loss_first=losses[0],
        loss_last=losses[-1], first10_mean=first, last10_mean=last,
        s_per_step=wall / len(losses), launches=launches["quickstart"])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    ckdir = _checkpoint_dir(TRAIN_CKPT_BYTES)
    try:
        path = os.path.join(ckdir, "train.npz")
        t0 = time.perf_counter()
        with _train_depth() as config:
            res = train.run(TRAIN_ARGS + ["--checkpoint", path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        base = {"losses": res.losses, "crc": checkpoint_crc(path),
                "checkpoint_bytes": os.path.getsize(path),
                "s_per_step": res.loop_seconds / len(res.losses),
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del res
    for loss in base["losses"]:
        _check_loss("train", loss)
    args = train.build_argparser().parse_args(TRAIN_ARGS)
    main_cfg = config(args.arch)
    launches["driver"] = _expect_launches(
        "train driver",
        _expect(main_cfg.n_layers, args.steps * args.accum_steps))
    base["launches"] = launches["driver"]
    log("train", run="launch.train", args=" ".join(TRAIN_ARGS),
        config=main_cfg.name, d_model=main_cfg.d_model,
        reduced=f"depth 40 -> {TRAIN_LAYERS}, for the checkpoint's size; "
                f"width as published", losses=base["losses"], crc=base["crc"],
        checkpoint_bytes=base["checkpoint_bytes"],
        s_per_step=base["s_per_step"], wall_s_with_init_and_checkpoint=wall,
        launches=launches["driver"],
        max_memory_allocated_gb=base["max_memory_allocated_gb"],
        seconds=time.perf_counter() - t_phase)
    torch.cuda.empty_cache()
    return launches, base


# ---------------------------------------------------------------------- #
# phase 9: where a step's device time goes
# ---------------------------------------------------------------------- #
def _category(kernel: str) -> str:
    if any(k in kernel for k in SSD_KERNELS):
        return "SSD (port kernels)"
    if "flash_decode_" in kernel:
        return "decode (port kernels)"
    if "flash_fwd_" in kernel or "flash_bwd_" in kernel:
        return "attention (port kernels)"
    low = kernel.lower()
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def _trace_totals(prof, device_type) -> dict:
    """{event key: [us, count]} over a finished profile's events on
    ``device_type``, in the order of their first start: the sums
    ``key_averages()`` gives for those keys (an event's time is 0 when it
    is async; the same names, filter and order as the profiler's), read
    from the raw trace. On a device, less its user annotations: the
    port's ``record_function`` spans, which the trace copies onto the
    device's timeline though they are no work of it.
    ``key_averages()`` first builds the profiler's event tree, ~16 s for
    a training step's trace."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    copies = device_type != DeviceType.CPU
    rows = []
    for e in res.events():
        name = e.name()
        if (e.device_type() != device_type or _filter_name(name)
                or getattr(e, "is_hidden_event", lambda: False)()
                or copies and getattr(e, "is_user_annotation",
                                      lambda: False)()):
            continue
        start, end = (e.start_ns() - t0) / 1000, (e.end_ns() - t0) / 1000
        timed = not (e.is_async() or e.start_thread_id() != e.end_thread_id())
        rows.append((start, -end, _rewrite_name(name, with_wildcard=True),
                     end - start if timed else 0))
    rows.sort(key=lambda r: r[:2])
    totals = {}
    for _, _, key, us in rows:
        tot = totals.setdefault(key, [0, 0])
        tot[0] += us
        tot[1] += 1
    return totals


def _op_device_us(events, ops) -> dict:
    """{host op in ``ops``: device us of the kernels it launched} over the
    profiler's events (its event tree: an op's kernels are its
    children's), as ``key_averages()`` sums them."""
    from torch.autograd import DeviceType
    by_op = {op: 0.0 for op in ops}
    for e in events:
        if e.key in by_op and e.device_type != DeviceType.CUDA:
            by_op[e.key] += (e.device_time_total
                             if hasattr(e, "device_time_total")
                             else e.cuda_time_total)      # torch < 2.4
    return by_op


# the port's spans (``repro_torch/util/spans.py``) that a training step's
# device time is put down to
SPAN = "repro_torch."
STEP_SPANS = ("repro_torch.executor.", "repro_torch.step.")
PHASE_SPANS = ("forward", "backward", "accumulate", "optimizer")
CALL_SPANS = ("attention", "attention_bwd", "ssd", "ssd_bwd")


def _enclosing(spans, queries) -> dict:
    """{instant in ``queries``: names of the spans (start, end, name),
    which nest, that contain it, outermost first}."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t in sorted(set(queries)):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[t] = tuple(n for _, e, n in stack if e >= t)
    return out


def _span_chains(events) -> list:
    """[(device ns, chain)] for each device operation of a finished
    profile's raw events (``kineto_results.events()``): ``chain`` the
    names of the port's spans open at its launch, or None where the
    launch cannot be followed.

    torch's own link: a device event's ``linked_correlation_id()`` is the
    ``correlation_id()`` of the host operator that launched it, and the
    runtime call that launched it carries both ids and the moment of the
    launch (else the operator's start stands for it). The step's spans
    are open on the thread that steps the jobs while the CUDA backward
    launches from autograd's device thread, so a launch takes the step's
    spans open on any thread at its moment; the unit, call and collector
    spans only from the launching thread."""
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    device, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not (_filter_name(e.name()) or getattr(
                    e, "is_user_annotation", lambda: False)()):
                device.append((e.end_ns() - e.start_ns(), e.correlation_id(),
                               e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            host.append(e)
    ops = {op for *_, op in device if op}
    launches = {cid for _, cid, op in device if op}
    op_at, launch_at = {}, {}
    spans = defaultdict(list)             # thread -> [(start, end, name)]
    for e in host:
        cid = e.correlation_id()
        if e.linked_correlation_id():     # a runtime call
            if cid in launches:
                launch_at[(cid, e.linked_correlation_id())] = e.start_ns()
            continue
        if e.name().startswith(SPAN):
            spans[e.start_thread_id()].append((e.start_ns(), e.end_ns(),
                                               e.name()))
        if cid in ops:
            op_at[cid] = (e.start_ns(), e.start_thread_id())
    at = [(launch_at.get((cid, op), op_at[op][0]), op_at[op][1])
          if op in op_at else None for _, cid, op in device]
    step = [s for rows in spans.values() for s in rows
            if s[2].startswith(STEP_SPANS)]
    any_thread = _enclosing(step, [a[0] for a in at if a])
    own = {tid: _enclosing([r for r in rows
                            if not r[2].startswith(STEP_SPANS)],
                           [a[0] for a in at if a and a[1] == tid])
           for tid, rows in spans.items()}
    return [(ns, None if a is None else
             any_thread[a[0]] + own.get(a[1], {}).get(a[0], ()))
            for (ns, _, _), a in zip(device, at)]


def _span_fields(prof) -> dict:
    """A profiled group step's device time (ms) put down to the port's
    spans: by step phase (``none`` where a launch has no phase or cannot
    be followed), the recompute (``model.unit`` spans inside the
    backward), by kernel call (attention, SSD and their backwards,
    whatever kernels do the work), and the ``micro_batch`` spans a
    ``step_group`` span holds; {} where the trace holds no
    ``step_group`` span (a profile without the host, or not of a step)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    host = [e.name() for e in events if e.device_type() == DeviceType.CPU
            and e.name().startswith(STEP_SPANS)]
    if "repro_torch.executor.step_group" not in host:
        return {}
    phases = dict.fromkeys(PHASE_SPANS + ("none",), 0.0)
    calls = dict.fromkeys(CALL_SPANS, 0.0)
    recompute = 0.0
    for ns, chain in _span_chains(events):
        names = {n.rsplit(".", 1)[-1] for n in chain or ()}
        phase = next((p for p in PHASE_SPANS if p in names), "none")
        phases[phase] += ns / 1e6
        recompute += ns / 1e6 if {"backward", "unit"} <= names else 0.0
        for c in CALL_SPANS:
            calls[c] += ns / 1e6 if c in names else 0.0
    return dict(by_phase_ms=phases, recompute_ms=recompute,
                by_call_ms=calls,
                micro_batch_spans=host.count("repro_torch.step.micro_batch")
                / host.count("repro_torch.executor.step_group"))


def _profile_fields(prof, wall_ms: float, ops=()) -> dict:
    """A trace's device time by kernel category, kernels launched and the
    device's busy share of ``wall_ms``, and by the port's spans
    (``_span_fields``); and, for each host op named in ``ops`` (exact
    profiler keys, e.g. ``aten::einsum``), the device time of the kernels
    it launched."""
    from torch.autograd import DeviceType
    by_cat, top, n_kernels = {}, [], 0
    for key, (us, count) in _trace_totals(prof, DeviceType.CUDA).items():
        t = us / 1e3                                # us -> ms
        cat = _category(key)
        by_cat[cat] = by_cat.get(cat, 0.0) + t
        top.append((t, key[:90], count))
        n_kernels += count
    by_op = {op: us / 1e3 for op, us in
             _op_device_us(prof.events() if ops else (), ops).items()}
    top.sort(reverse=True)
    device_ms = sum(by_cat.values())
    return dict(
        step_wall_ms=wall_ms, kernels_per_step=n_kernels,
        device_ms=device_ms if device_ms else "not measured",
        busy_share=device_ms / wall_ms if device_ms else "not measured",
        by_category_ms=by_cat,
        top_kernels=[{"ms": t, "name": n, "calls": c}
                     for t, n, c in top[:8]],
        **_span_fields(prof), **({"by_host_op_ms": by_op} if ops else {}))


# micro-batches of a profiled training step (at 4 the profiler's trace
# of each step took the smoke past its time limit on a slow host)
PROFILE_ACCUM = 2


def _profile_step(phase: str, cfg, ops=()):
    """One profiled step of ``cfg`` at s = ``PROFILE_ACCUM`` after a
    warm-up step (``_profile_fields``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
    from repro_torch.models import param_count
    ex = ScheduleExecutor()
    spec = JobSpec(cfg, batch=BATCH, accum_steps=PROFILE_ACCUM, seq=SEQ,
                   seed=0)
    ex.submit(cfg.name, spec, steps=2)
    ex.start(cfg.name)
    n_params = param_count(ex.runs[cfg.name].params)
    ex.step_group([cfg.name])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = ex.step_group([cfg.name])
    log(phase, profile=True, model=cfg.name, n_layers=cfg.n_layers,
        params=n_params, accum_steps=PROFILE_ACCUM,
        **_profile_fields(prof, res["walltime"] * 1e3, ops))
    del ex
    torch.cuda.empty_cache()


def phase_profile():
    from repro_torch.configs import get_config
    for name in ("minicpm-2b", "qwen2-vl-2b"):
        _profile_step("profile", get_config(name))


# ---------------------------------------------------------------------- #
# phase 10: the hybrid family through the executor
# ---------------------------------------------------------------------- #
def _expect_hybrid(cfg, micro: int) -> dict:
    # remat per unit: each micro-batch runs every unit's forward twice
    # (its Mamba2 layers' SSD and the shared block's attention) and its
    # backward once
    return {"ssd_fwd": 2 * cfg.n_layers * micro,
            "ssd_bwd": cfg.n_layers * micro,
            "flash_fwd": 2 * cfg.n_units * micro,
            "flash_bwd_dq": cfg.n_units * micro,
            "flash_bwd_dkdv": cfg.n_units * micro}


def phase_hybrid(iters: int = 2):
    """zamba2-7b at full width, ``HYBRID_LAYERS`` of its 81 layers, bf16,
    through ``ScheduleExecutor``: 2 steps at s = 4, a reconfig to s = 2
    (1 step), one ragged step (B = 5, b = 2, s = 3), with launch counts
    equal to layers x micro-batches; then ``measure_pair`` with
    qwen2-vl-2b at s = 4, and one profiled step."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.coschedule import measure_pair
    from repro_torch.data import make_batch
    from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
    from repro_torch.models import param_count
    full = get_config("zamba2-7b")
    cfg = dataclasses.replace(full, n_layers=HYBRID_LAYERS)
    ex = ScheduleExecutor()
    ex.submit("zamba", JobSpec(cfg, batch=BATCH, seq=SEQ, seed=0), steps=3)
    ex.start("zamba", sub_batch=1)
    log("hybrid", config=cfg.name, family=cfg.family, d_model=cfg.d_model,
        n_layers=cfg.n_layers, of_layers=full.n_layers, units=cfg.n_units,
        layers_per_unit=cfg.pattern_unit(), ssm_heads=cfg.n_ssm_heads,
        head_p=cfg.d_inner // cfg.n_ssm_heads, ssm_state=cfg.ssm_state,
        attn_heads=cfg.n_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
        vocab=cfg.vocab, dtype=cfg.dtype,
        params=param_count(ex.runs["zamba"].params),
        reduced=f"depth {full.n_layers} -> {cfg.n_layers} layers "
                f"({cfg.n_units} of {full.n_units} units); widths as "
                f"published", seq=SEQ, batch=BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    micro = 0
    for sub, n in ((None, 2), (2, 1)):      # (reconfig sub-batch, steps)
        if sub is not None:
            ex.reconfigure("zamba", sub)
        run = ex.runs["zamba"]
        for _ in range(n):
            res = ex.step_group(["zamba"])
            loss = res["losses"]["zamba"]
            _check_loss("hybrid", loss)
            micro += run.accum_steps
            log("hybrid", job="zamba", step=run.steps_done,
                sub_batch=run.sub_batch, accum_steps=run.accum_steps,
                loss=loss, walltime_s=res["walltime"])
    run = ex.runs["zamba"]
    state = (run.params, run.opt,
             make_batch(cfg, 5, SEQ, seed=0, device="cuda"))
    ex.finish("zamba")
    ex.submit("zamba-ragged", JobSpec(cfg, batch=5, seq=SEQ, seed=0),
              steps=1)
    ex.start("zamba-ragged", sub_batch=2, state=state)
    del state, run
    res = ex.step_group(["zamba-ragged"])
    ragged = ex.runs["zamba-ragged"]
    loss = res["losses"]["zamba-ragged"]
    _check_loss("hybrid", loss)
    micro += ragged.accum_steps
    log("hybrid", job="zamba-ragged", step=ragged.steps_done, batch=5,
        sub_batch=ragged.sub_batch, accum_steps=ragged.accum_steps,
        loss=loss, walltime_s=res["walltime"])
    ex.finish("zamba-ragged")
    if micro != 2 * 4 + 2 + 3:
        raise AssertionError(f"hybrid: {micro} micro-batches, expected 13")
    launches = _expect_launches("hybrid", _expect_hybrid(cfg, micro))
    log("hybrid", summary=True, micro_batches=micro, launches=launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del ex, ragged
    torch.cuda.empty_cache()

    # the pair with qwen2-vl-2b: solo a, solo b, then the pair, each
    # (iters + 1) steps with the warm-up
    cfg_b = get_config("qwen2-vl-2b")
    s = 4
    spec_a = JobSpec(cfg, batch=BATCH, accum_steps=s, seq=SEQ, seed=0)
    spec_b = JobSpec(cfg_b, batch=BATCH, accum_steps=s, seq=SEQ, seed=1)
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    r = measure_pair(spec_a, spec_b, iters=iters)
    steps = (iters + 1) * 2
    want = _expect_hybrid(cfg, steps * s)
    for key, n in _expect(cfg_b.n_layers, steps * s).items():
        want[key] += n
    pair_launches = _expect_launches("hybrid pair", want)
    for key in ("t_a_solo", "t_b_solo", "t_pair"):
        if not (math.isfinite(r[key]) and r[key] > 0):
            raise AssertionError(f"hybrid pair: {key} = {r[key]}")
    log("hybrid", pair=True, a=f"{cfg.name}@{cfg.n_layers}",
        b="qwen2-vl-2b", accum_steps=s, **r, launches=pair_launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.empty_cache()
    _profile_step("hybrid", cfg)
    return launches


# ---------------------------------------------------------------------- #
# phase 11: accumulated == full batch on the card
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
    for name, n_layers in (("minicpm-2b", None), ("qwen2-vl-2b", None),
                           ("zamba2-7b", 9), ("zamba2-7b", 18)):
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="float32")
        if n_layers:                  # the hybrid's 1- and 2-unit variants
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
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
            log("accum", model=cfg.name, n_layers=cfg.n_layers,
                batch=batch_size,
                accum_steps=steps, loss_full=float(loss_full),
                loss_acc=float(loss_acc), max_abs_grad_diff=worst,
                rtol=5e-4, atol=5e-6)


# ---------------------------------------------------------------------- #
# phase 12: serving through generate
# ---------------------------------------------------------------------- #
def phase_serve():
    """minicpm-2b at full width, bf16: batch 4, 1024-token prompts, 16
    greedy tokens through ``generate``, device loop and eager loop."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params
    cfg = get_config("minicpm-2b")
    params = init_params(cfg, 0)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)))
    kw = dict(max_new_tokens=SERVE_NEW, max_len=MAX_LEN)
    serve.generate(cfg, params, prompt[:, :64], max_new_tokens=2,
                   max_len=128)                       # warm-up
    # prefill alone, for its time
    cache = init_cache(cfg, SERVE_BATCH, MAX_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.prefill_one_shot(cfg, params, prompt.cuda(), cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del cache
    torch.cuda.empty_cache()
    expect = {"flash_fwd": cfg.n_layers,
              "flash_decode": cfg.n_layers * SERVE_NEW}
    toks, launches = {}, {}
    for engine in ("scan", "eager"):
        torch.cuda.reset_peak_memory_stats()
        _reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks[engine] = serve.generate(cfg, params, prompt, engine=engine,
                                      **kw)
        wall = time.perf_counter() - t0
        launches[engine] = _expect_launches(f"serve {engine}", expect)
        decode_s = wall - prefill_ms / 1e3
        log("serve", model=cfg.name, engine=engine, batch=SERVE_BATCH,
            prompt=SERVE_PROMPT, new_tokens=SERVE_NEW, wall_s=wall,
            prefill_ms=prefill_ms,
            ms_per_decode_step=decode_s * 1e3 / SERVE_NEW,
            decode_tokens_per_s=SERVE_BATCH * SERVE_NEW / decode_s,
            launches=launches[engine],
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not torch.equal(toks["scan"], toks["eager"]):
        raise AssertionError("serve: scan and eager tokens differ")
    if tuple(toks["scan"].shape) != (SERVE_BATCH, SERVE_NEW) or int(
            toks["scan"].min()) < 0 or int(toks["scan"].max()) >= cfg.vocab:
        raise AssertionError(f"serve: bad tokens {toks['scan']}")
    log("serve", summary=True, tokens_equal=True,
        first_tokens=toks["scan"][0, :8].tolist())
    _profile_decode(cfg, params, prompt)
    del params
    torch.cuda.empty_cache()
    return launches["scan"]


# decode steps a decode profile traces: few, as the profiler's cost grows
# with the kernels it records (2.7-5.9k a step)
PROFILE_DECODE_STEPS = 2     # the smoke's time limit (4 took longer)


def _profile_decode(cfg, params, prompt, steps: int = PROFILE_DECODE_STEPS,
                    phase="serve"):
    """Device time of ``steps`` decode steps after a prefill, by kernel
    category (``_category``), and the device's busy share of their wall
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.models import init_cache
    _, cache = serve.prefill_one_shot(cfg, params, prompt.cuda(),
                                      init_cache(cfg, SERVE_BATCH, MAX_LEN))
    run = serve._make_scan_generate(cfg, steps, True)
    tok = prompt[:, -1:].cuda()
    run(params, cache, tok)                        # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(params, cache, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat, n_kernels = {}, 0
    for key, (us, count) in _trace_totals(prof, DeviceType.CUDA).items():
        n_kernels += count
        cat = _category(key)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3
    device_ms = sum(by_cat.values())
    log(phase, profile=True, model=cfg.name, n_layers=cfg.n_layers,
        decode_steps=steps, wall_ms=wall_ms,
        device_ms=device_ms if device_ms else "not measured",
        busy_share=device_ms / wall_ms if device_ms else "not measured",
        kernels_per_step=n_kernels / steps, by_category_ms=by_cat)
    del cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# phase 13: the continuous-batching engine
# ---------------------------------------------------------------------- #
def _engine_requests(cfg):
    """16 prompts: a shared 1024-token system prefix plus 256-1024 tokens
    of their own; 16-48 new tokens each. All from one seed."""
    import numpy as np
    rng = np.random.default_rng(1)
    system = rng.integers(0, cfg.vocab, SYSTEM_PREFIX)
    return [(np.concatenate([system, rng.integers(
        0, cfg.vocab, int(rng.integers(256, 1025)))]),
        int(rng.integers(16, 49))) for _ in range(ENGINE_REQUESTS)]


def _agreement(a, b) -> dict:
    """How many requests have identical tokens; for the others, the first
    position where they part."""
    split = {i: next(j for j, (x, y) in enumerate(zip(p, q)) if x != y)
             for i, (p, q) in enumerate(zip(a, b)) if p != q}
    return {"identical": len(a) - len(split), "of": len(a),
            "first_divergence": split}


def _run_engine(cfg, params, reqs, expect_launches, **kw):
    """Every request through one ``DecodeEngine``; returns (tokens per
    request, stats, launches, wall seconds). Launch counts are checked
    against ``expect_launches(stats)``."""
    import torch
    from repro_torch.launch.engine import DecodeEngine
    eng = DecodeEngine(cfg, params, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n) for p, n in reqs]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(eng.stats)
    launches = _expect_launches(f"engine {kw}", expect_launches(st))
    toks = [out[r] for r in rids]
    if [len(o) for o in toks] != [n for _, n in reqs]:
        raise AssertionError(f"engine {kw}: token counts differ")
    return toks, st, launches, wall


def _serve_counts(cfg):
    """(attention blocks, SSD calls) of one pass over the layers: one
    attention block per layer, or, for the hybrid, one per application
    of the shared block and one SSD per Mamba2 layer."""
    if cfg.family == "hybrid":
        return cfg.n_units, cfg.n_layers
    return _attention_calls(cfg), 0


def _engine_launches(cfg, segment, n_reqs, paged):
    # every admission prefills once through the flash forward (one-shot
    # for a miss, at a query offset for a prefix hit) and, for the
    # hybrid, the SSD; every slot-step of every segment decodes once per
    # attention block
    decode = "flash_decode_paged" if paged else "flash_decode"
    n_attn, n_ssd = _serve_counts(cfg)
    return lambda st: {decode: n_attn * st["segments"] * segment,
                       "flash_fwd": n_attn * n_reqs,
                       "ssd_fwd": n_ssd * n_reqs}


def _cublas_rows(cfg, params, ms) -> dict:
    """Whether a cuBLAS product's rows depend on how many rows the call
    has: the last m rows of x @ W (x of 2048 rows) against x[-m:] @ W,
    bitwise, for each first-layer weight and each m in ``ms``; returns
    the m where they differ. Outside the attention kernels this is the
    only arithmetic a suffix prefill does differently from a
    whole-prompt prefill (every other op is row by row)."""
    import torch
    from repro_torch.models.layers import linear
    from repro_torch.tree import unit_slice
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    unit = unit_slice(params["units"], 0)
    x = {}
    out = {}
    for block, ps in unit.items():
        if not isinstance(ps, dict):
            continue
        for name, p in ps.items():
            if not isinstance(p, dict) or p["w"].dim() != 2:
                continue
            d_in = p["w"].shape[0]
            if d_in not in x:
                x[d_in] = torch.randn((1, 2048, d_in), generator=gen,
                                      device="cuda").to(p["w"].dtype)
            full = linear(p, x[d_in])
            out[f"{block}.{name}"] = [
                m for m in ms
                if not torch.equal(linear(p, x[d_in][:, -m:]),
                                   full[:, -m:])]
    return out


def _engine_small(name="qwen2-vl-2b", n_layers=None, phase=None,
                  long=False, **overrides):
    """The engines and solo ``generate`` on a reduced ``name`` in f32
    (with ``overrides`` of its config), on the card: every token identity
    the CPU tests pin must hold here too. The dense engine for every
    config, the paged one where the cache is linear (no sliding window),
    and the prefix-shared one where the suffix prefill is bitwise (dense
    and vlm, and moe under the dense dispatch): a 40-token shared prefix
    is 2.5 pages of 16, so hits map two shared pages and fork the
    boundary page copy-on-write; ``debug=True`` audits the paging
    invariants every segment. ``long``: a 520-token shared prefix, prompts
    of 620-1120 tokens and max_len 1280, so every slot's decode spans
    several splits of 128, 256 or 512 key positions."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    from repro_torch.models.model import has_linear_kv
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32",
                              **overrides)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    paged = has_linear_kv(cfg)
    share = paged and (cfg.family in ("dense", "vlm") or (
        cfg.family == "moe" and cfg.moe_dispatch == "dense"))
    params = init_params(cfg, 2)
    rng = np.random.default_rng(2)
    prefix, own, max_len = (520, (100, 600), 1280) if long \
        else (40, (3, 30), 128)
    system = rng.integers(0, cfg.vocab, prefix)
    reqs = [(np.concatenate([system, rng.integers(
        0, cfg.vocab, int(rng.integers(*own)))]), int(rng.integers(8, 25)))
        for _ in range(8)]
    kw = dict(n_slots=4, max_len=max_len, segment=8)
    ways = {"dense": {}}
    if paged:
        ways["paged"] = {"paged": True, "page_size": 16}
    if share:
        ways["prefix_shared"] = {"paged": True, "page_size": 16,
                                 "prefix_share": True, "debug": True}
    outs, stats = {}, {}
    for way, extra in ways.items():
        outs[way], stats[way], _, _ = _run_engine(
            cfg, params, reqs, _engine_launches(cfg, 8, len(reqs),
                                                extra.get("paged")),
            **kw, **extra)
    solo = [serve.generate(cfg, params, torch.as_tensor(p)[None, :],
                           max_new_tokens=n, max_len=max_len)[0].tolist()
            for p, n in reqs]
    row = {"config": f"{cfg.name}, {cfg.n_layers} layers, float32",
           "overrides": overrides, "requests": len(reqs),
           "prompt_tokens": [len(p) for p, _ in reqs], "max_len": max_len,
           "engine_vs_solo": _agreement(outs["dense"], solo)}
    ok = outs["dense"] == solo
    if paged:
        row["paged_vs_dense"] = _agreement(outs["paged"], outs["dense"])
        ok = ok and outs["paged"] == outs["dense"]
    if share:
        st = stats["prefix_shared"]
        row.update(prefix_hits=st["prefix_hits"], cow_forks=st["cow_forks"],
                   prefix_shared_vs_private=_agreement(
                       outs["prefix_shared"], outs["paged"]))
        ok = (ok and outs["prefix_shared"] == outs["paged"]
              and st["prefix_hits"] > 0 and st["cow_forks"] > 0)
    log(phase or ("hybrid_serve" if cfg.family == "hybrid" else "engine"),
        small=True, **row)
    if not ok:
        raise AssertionError(f"engine (reduced, f32): identities fail "
                             f"{row}")
    return row


def phase_engine():
    """qwen2-vl-2b at full width, bf16: 16 requests through an 8-slot
    ``DecodeEngine`` run dense, paged and prefix-shared; then the same
    three and solo generation on a reduced config in f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    cfg = get_config("qwen2-vl-2b")
    params = init_params(cfg, 1)
    reqs = _engine_requests(cfg)
    ways = {"dense": {}, "paged": {"paged": True, "page_size": 16},
            "prefix_shared": {"paged": True, "page_size": 16,
                              "prefix_share": True}}
    outs, launches = {}, {}
    for way, kw in ways.items():
        outs[way], st, launches[way], wall = _run_engine(
            cfg, params, reqs,
            _engine_launches(cfg, ENGINE_SEGMENT, len(reqs),
                             kw.get("paged")),
            n_slots=ENGINE_SLOTS, max_len=MAX_LEN, segment=ENGINE_SEGMENT,
            **kw)
        useful = sum(len(o) for o in outs[way])
        log("engine", model=cfg.name, way=way, wall_s=wall,
            segments=st["segments"], decode_s=st["decode_seconds"],
            decode_tokens_per_s=useful / st["decode_seconds"],
            slot_steps_per_s=(ENGINE_SLOTS * ENGINE_SEGMENT * st["segments"]
                              / st["decode_seconds"]),
            peak_active_slots=st["peak_active_slots"],
            peak_pages=st.get("peak_pages_in_use"),
            prefix_hits=st.get("prefix_hits"),
            prefix_hit_rate=st.get("prefix_hit_rate"),
            prefill_tokens_saved=st.get("prefill_tokens_saved"),
            cow_forks=st.get("cow_forks"), launches=launches[way],
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.empty_cache()
    # paged == dense is bitwise by construction: the same kernels' sums
    # in the same order at the same batch shapes. Engine == solo: a decode
    # row's products do not depend on the other slots' rows.
    # Prefix-shared == private: a hit's suffix prefill gives the one-shot
    # prefill's attention rows bitwise (parity phase), every other op is
    # row by row, and the cuBLAS products give the same rows at each
    # suffix's row count; the probe reports the row counts where they
    # would not (2 and 256 as markers, then this run's suffix lengths).
    suffixes = sorted({len(p) - SYSTEM_PREFIX for p, _ in reqs})
    solo = []
    for i in (0, ENGINE_REQUESTS - 1):
        p, n = reqs[i]
        toks = serve.generate(cfg, params, torch.as_tensor(p)[None, :],
                              max_new_tokens=n, max_len=MAX_LEN)
        solo.append(toks[0].tolist())
    summary = {
        "paged_vs_dense": _agreement(outs["paged"], outs["dense"]),
        "engine_vs_solo": _agreement(
            [outs["dense"][0], outs["dense"][-1]], solo),
        "prefix_shared_vs_private": _agreement(outs["prefix_shared"],
                                               outs["paged"]),
        "cublas_rows_differ_at_m": _cublas_rows(cfg, params,
                                                [2, 256] + suffixes)}
    log("engine", summary=True, **summary)
    for key in ("paged_vs_dense", "engine_vs_solo",
                "prefix_shared_vs_private"):
        if summary[key]["identical"] != summary[key]["of"]:
            raise AssertionError(f"engine: {key} {summary[key]}")
    del params
    torch.cuda.empty_cache()
    _engine_small()
    return launches["paged"]


# ---------------------------------------------------------------------- #
# phase 15: serving the hybrid at full depth
# ---------------------------------------------------------------------- #
def _hybrid_requests(cfg):
    """16 prompts of 256-1024 tokens, 16-32 new tokens each, from one
    seed."""
    import numpy as np
    rng = np.random.default_rng(4)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(256, 1025))),
             int(rng.integers(16, 33))) for _ in range(ENGINE_REQUESTS)]


def phase_hybrid_serve(tuned_table=None):
    """zamba2-7b at all 81 layers and full width, bf16: ``generate`` at
    batch 4 (1024-token prompts, 16 greedy tokens; prefill and decode
    times, launch counts exact), a profile of 2 decode steps, the
    ``DecodeEngine`` dense and paged on 16 requests (paged == dense and
    engine == solo ``generate``, bitwise); then ``generate`` again with
    and without ``tuned_table`` (the ``autotune`` phase's payload: its
    split at head_dim 112 is the shared block's); then the same
    identities on a reduced zamba2 in f32. Every run but the last
    comparison's is made with no table installed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params, param_count
    t_phase = time.perf_counter()
    cfg = get_config("zamba2-7b")
    n_attn, n_ssd = _serve_counts(cfg)
    params = init_params(cfg, 3)
    log("hybrid_serve", config=cfg.name, n_layers=cfg.n_layers,
        units=cfg.n_units, layers_per_unit=cfg.pattern_unit(),
        params=param_count(params), dtype=cfg.dtype, reduced="nothing",
        batch=SERVE_BATCH, prompt=SERVE_PROMPT, new_tokens=SERVE_NEW,
        max_len=MAX_LEN)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)))
    serve.generate(cfg, params, prompt[:, :64], max_new_tokens=2,
                   max_len=128)                       # warm-up
    # prefill alone, for its time and its launches
    cache = init_cache(cfg, SERVE_BATCH, MAX_LEN)
    torch.cuda.synchronize()
    _reset_all()
    t0 = time.perf_counter()
    serve.prefill_one_shot(cfg, params, prompt.cuda(), cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = _expect_launches(
        "hybrid_serve prefill", {"ssd_fwd": n_ssd, "flash_fwd": n_attn})
    del cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve.generate(cfg, params, prompt, max_new_tokens=SERVE_NEW,
                          max_len=MAX_LEN)
    wall = time.perf_counter() - t0
    launches = _expect_launches("hybrid_serve generate", {
        "ssd_fwd": n_ssd, "flash_fwd": n_attn,
        "flash_decode": n_attn * SERVE_NEW})
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_NEW) or int(
            toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"hybrid_serve: bad tokens {toks}")
    decode_s = wall - prefill_ms / 1e3
    log("hybrid_serve", model=cfg.name, engine="scan", wall_s=wall,
        prefill_ms=prefill_ms, prefill_launches=prefill_launches,
        ms_per_decode_step=decode_s * 1e3 / SERVE_NEW,
        decode_tokens_per_s=SERVE_BATCH * SERVE_NEW / decode_s,
        launches=launches, first_tokens=toks[0, :8].tolist(),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    _profile_decode(cfg, params, prompt, phase="hybrid_serve")

    reqs = _hybrid_requests(cfg)
    ways = {"dense": {}, "paged": {"paged": True, "page_size": 16}}
    outs, paths = {}, {"generate": launches}
    for way, kw in ways.items():
        outs[way], st, paths[f"engine {way}"], eng_wall = _run_engine(
            cfg, params, reqs,
            _engine_launches(cfg, ENGINE_SEGMENT, len(reqs),
                             kw.get("paged")),
            n_slots=ENGINE_SLOTS, max_len=MAX_LEN, segment=ENGINE_SEGMENT,
            **kw)
        log("hybrid_serve", model=cfg.name, way=way, wall_s=eng_wall,
            requests=len(reqs), segments=st["segments"],
            decode_s=st["decode_seconds"],
            decode_tokens_per_s=(sum(len(o) for o in outs[way])
                                 / st["decode_seconds"]),
            slot_steps_per_s=(ENGINE_SLOTS * ENGINE_SEGMENT * st["segments"]
                              / st["decode_seconds"]),
            peak_active_slots=st["peak_active_slots"],
            peak_pages=st.get("peak_pages_in_use"),
            launches=paths[f"engine {way}"],
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.empty_cache()
    solo = [serve.generate(cfg, params, torch.as_tensor(reqs[i][0])[None, :],
                           max_new_tokens=reqs[i][1],
                           max_len=MAX_LEN)[0].tolist()
            for i in (0, len(reqs) - 1)]
    summary = {"paged_vs_dense": _agreement(outs["paged"], outs["dense"]),
               "engine_vs_solo": _agreement(
                   [outs["dense"][0], outs["dense"][-1]], solo)}
    log("hybrid_serve", summary=True, **summary)
    for key, agree in summary.items():
        if agree["identical"] != agree["of"]:
            raise AssertionError(f"hybrid_serve: {key} {agree}")
    if tuned_table is not None:
        _tuned_decode_step(cfg, params, prompt, prefill_ms, tuned_table)
    del params
    torch.cuda.empty_cache()
    _engine_small("zamba2-7b", n_layers=18)
    log("hybrid_serve", seconds=time.perf_counter() - t_phase)
    return paths


TUNED_STEP_NEW = 16


def _tuned_decode_step(cfg, params, prompt, prefill_ms, payload) -> dict:
    """``generate`` (batch 4, 1024-token prompts, 16 tokens) with no
    table, under ``payload``, under it again and with none again: each
    run's seconds and ms a decode step (its seconds less the prefill's,
    over 16), each table's launches, and whether the tokens agree. What
    the autotuned split moves on the path a user calls; reported, not
    gated (a host-bound step; the ``autotune`` phase gates the kernels'
    own times)."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.launch import serve
    table = autotune.AutotuneTable(payload)
    n_attn, _ = _serve_counts(cfg)
    runs, toks, launches = [], {}, {}
    try:
        for label in ("none", "tuned", "tuned", "none"):
            autotune.set_table(table if label == "tuned" else None)
            _reset_all()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks[label] = serve.generate(cfg, params, prompt,
                                         max_new_tokens=TUNED_STEP_NEW,
                                         max_len=MAX_LEN)
            wall = time.perf_counter() - t0
            launches[label] = _launches()
            runs.append({"table": label, "wall_s": wall,
                         "ms_per_decode_step":
                         (wall * 1e3 - prefill_ms) / TUNED_STEP_NEW})
    finally:
        autotune.set_table(None)
    best = {label: min(r["ms_per_decode_step"] for r in runs
                       if r["table"] == label) for label in ("none", "tuned")}
    row = {"model": cfg.name, "tuned_decode_step": True,
           "split_at_d112": (table.lookup("flash_decode", MAX_LEN, 112,
                                          torch.bfloat16, "cuda")
                             or autotune.DEFAULTS["flash_decode"])["split"],
           "new_tokens": TUNED_STEP_NEW, "runs": runs,
           "best_ms_per_decode_step": best,
           "tuned_over_none": best["tuned"] / best["none"],
           "tokens_equal": bool(torch.equal(toks["none"], toks["tuned"])),
           "launches": launches}
    log("hybrid_serve", **row)
    if launches["tuned"]["flash_decode"] != n_attn * TUNED_STEP_NEW:
        raise AssertionError(f"hybrid_serve: tuned generate launched "
                             f"{launches['tuned']}")
    return row


# ---------------------------------------------------------------------- #
# phase 16: the remaining dense families and MoE
# ---------------------------------------------------------------------- #
def _executor_steps(phase: str, job: str, cfg, schedule, batch=BATCH,
                    seq=SEQ, sub_batch=1, profile_last=False) -> dict:
    """``cfg`` through ``ScheduleExecutor`` (B = 4, seq 2048 unless
    given), bf16: ``schedule`` of (reconfigured sub-batch or None, steps)
    from ``sub_batch`` (1: s = 4). Finite losses, flash launch counts
    exact (remat: two forwards per attention call and micro-batch); step
    times and peak memory; with ``profile_last`` the last step traced on
    the device alone (``_profile_fields``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
    from repro_torch.models import param_count
    ex = ScheduleExecutor()
    ex.submit(job, JobSpec(cfg, batch=batch, seq=seq, seed=0),
              steps=sum(n for _, n in schedule))
    ex.start(job, sub_batch=sub_batch)
    log(phase, job=job, config=cfg.name, family=cfg.family,
        n_layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
        kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        params=param_count(ex.runs[job].params), dtype=cfg.dtype,
        moe_dispatch=cfg.moe_dispatch if cfg.family == "moe" else None,
        seq=seq, batch=batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    micro, walls, left = 0, [], sum(n for _, n in schedule)
    for sub, n in schedule:
        if sub is not None:
            ex.reconfigure(job, sub)
        run = ex.runs[job]
        for _ in range(n):
            left -= 1
            if profile_last and not left:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    res = ex.step_group([job])
                log(phase, profile=True, job=job, model=cfg.name,
                    step=run.steps_done, accum_steps=run.accum_steps,
                    **_profile_fields(prof, res["walltime"] * 1e3))
            else:
                res = ex.step_group([job])
            loss = res["losses"][job]
            _check_loss(phase, loss)
            micro += run.accum_steps
            walls.append(res["walltime"])
            log(phase, job=job, step=run.steps_done, sub_batch=run.sub_batch,
                accum_steps=run.accum_steps, loss=loss,
                walltime_s=res["walltime"])
    ex.finish(job)
    launches = _expect_launches(f"{phase} {job}",
                                _expect(_attention_calls(cfg), micro))
    log(phase, job=job, summary=True, micro_batches=micro,
        launches=launches, mean_step_s_after_first=(
            sum(walls[1:]) / len(walls[1:]) if len(walls) > 1 else None),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del ex, run
    torch.cuda.empty_cache()
    return launches


def _generate_run(phase: str, cfg, params, prompt, max_len: int, new: int,
                  cache_rows=None, frames=None) -> dict:
    """``generate`` at full width: the prefill alone (its time, with the
    encoder's run over ``frames`` for an encoder-decoder; its launches
    and, where ``cache_rows`` is given, the rows its cache holds a
    layer), then ``engine="scan"`` and ``"eager"`` with equal tokens and
    exact launches (one flash forward per attention call for the
    prefill, one flash decode per decoder attention call and step; none
    for xLSTM): prefill ms, ms a decode step, tokens/s and peak
    memory."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import init_cache
    from repro_torch.models.model import prefill_cache_whisper
    from repro_torch.tree import flatten
    b, plen = prompt.shape
    serve.generate(cfg, params, prompt[:, :64], max_new_tokens=2,
                   max_len=128, frames=frames)        # warm-up
    cache = init_cache(cfg, b, max_len)
    rows = {k: t.shape[2] for k, t in flatten(cache["units"]).items()}
    if cache_rows is not None and set(rows.values()) != {cache_rows}:
        raise AssertionError(f"{phase}: {cfg.name} cache rows {rows}, "
                             f"expected {cache_rows}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    t0 = time.perf_counter()
    if frames is not None:
        cache = prefill_cache_whisper(cfg, params, frames, b, max_len)
    serve.prefill_one_shot(cfg, params, prompt.cuda(), cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    n_attn = _attention_calls(cfg)
    prefill_launches = _expect_launches(f"{phase} {cfg.name} prefill",
                                        {"flash_fwd": n_attn})
    log(phase, model=cfg.name, prefill=True, batch=b, prompt=plen,
        cache_rows_per_layer=sorted(set(rows.values())),
        prefill_ms=prefill_ms, launches=prefill_launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del cache
    torch.cuda.empty_cache()
    n_dec = n_attn - (cfg.encoder_layers if cfg.is_encoder_decoder else 0)
    expect = {"flash_fwd": n_attn, "flash_decode": n_dec * new}
    toks, launches = {}, {}
    for engine in ("scan", "eager"):
        torch.cuda.reset_peak_memory_stats()
        _reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks[engine] = serve.generate(cfg, params, prompt, engine=engine,
                                      max_new_tokens=new, max_len=max_len,
                                      frames=frames)
        wall = time.perf_counter() - t0
        launches[engine] = _expect_launches(f"{phase} {cfg.name} {engine}",
                                            expect)
        decode_s = wall - prefill_ms / 1e3
        log(phase, model=cfg.name, engine=engine, batch=b, prompt=plen,
            new_tokens=new, max_len=max_len, wall_s=wall,
            prefill_ms=prefill_ms, ms_per_decode_step=decode_s * 1e3 / new,
            decode_tokens_per_s=b * new / decode_s,
            launches=launches[engine],
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not torch.equal(toks["scan"], toks["eager"]):
        raise AssertionError(f"{phase}: {cfg.name} scan and eager tokens "
                             f"differ")
    if tuple(toks["scan"].shape) != (b, new) or int(
            toks["scan"].min()) < 0 or int(toks["scan"].max()) >= cfg.vocab:
        raise AssertionError(f"{phase}: {cfg.name} bad tokens "
                             f"{toks['scan']}")
    log(phase, model=cfg.name, tokens_equal=True,
        first_tokens=toks["scan"][0, :8].tolist())
    return launches["scan"]


STABLELM_TRAIN_LAYERS = 8
# granite-moe trains at 16 of its 32 layers: at 32 its profiled step took
# 60 s of the smoke's 1200 (the profiler's cost grows with the 70k
# kernels a step); it serves at 32
GRANITE_TRAIN_LAYERS = 16


def phase_families():
    """The remaining dense families and MoE at full published width, bf16:
    (a) stablelm-12b at all 40 layers (head_dim 160) through
    ``generate``; (b) stablelm-12b at 8 of 40 layers through
    ``ScheduleExecutor`` (the head_dim 160 backward on the model's path);
    (c) glm4-9b at all 40 layers with the reference's long-context
    sliding window of 8192, prompts past it by 1024, through ``generate``
    (a ring buffer of 8192 rows a layer); (d) granite-moe-3b-a800m,
    einsum dispatch, at 16 of 32 layers through ``ScheduleExecutor`` and
    a profiled step with the MoE einsums' device time, at all 32 through
    ``generate``; (e) reduced
    f32 configs through the engines, every token identity required: a
    windowed glm4-9b (window 16) dense == solo; granite-moe and
    llama4-maverick under the dense dispatch (capacity factor 8, the
    reference's test override) paged == dense, prefix-shared == private,
    engine == solo."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count
    t_phase = time.perf_counter()
    paths = {}
    rng = np.random.default_rng(6)

    cfg = get_config("stablelm-12b")
    params = init_params(cfg, 5)
    log("families", config=cfg.name, n_layers=cfg.n_layers,
        head_dim=cfg.head_dim, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
        params=param_count(params), dtype=cfg.dtype, reduced="nothing")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (SERVE_BATCH, SERVE_PROMPT)))
    paths["stablelm-12b generate"] = _generate_run(
        "families", cfg, params, prompt, MAX_LEN, SERVE_NEW)
    _profile_decode(cfg, params, prompt, phase="families")
    del params
    torch.cuda.empty_cache()
    paths["stablelm-12b@8 executor"] = _executor_steps(
        "families", "stablelm", dataclasses.replace(
            cfg, n_layers=STABLELM_TRAIN_LAYERS), ((None, 2), (2, 1)))

    cfg = dataclasses.replace(get_config("glm4-9b"),
                              sliding_window=LONG_WINDOW)
    params = init_params(cfg, 6)
    log("families", config=cfg.name, n_layers=cfg.n_layers,
        sliding_window=cfg.sliding_window, heads=cfg.n_heads,
        kv_heads=cfg.n_kv_heads, qkv_bias=cfg.qkv_bias,
        params=param_count(params), dtype=cfg.dtype,
        reduced="nothing; the window is the reference's long-context "
                "variant (configs/shapes.py: variant_for_shape)")
    plen = LONG_WINDOW + 1024
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (2, plen)))
    paths["glm4-9b window generate"] = _generate_run(
        "families", cfg, params, prompt, plen + SERVE_NEW, SERVE_NEW,
        cache_rows=LONG_WINDOW)
    del params
    torch.cuda.empty_cache()

    cfg = get_config("granite-moe-3b-a800m")
    train = dataclasses.replace(cfg, n_layers=GRANITE_TRAIN_LAYERS)
    paths["granite-moe@16 executor"] = _executor_steps(
        "families", "granite", train, ((None, 2), (2, 1)))
    _profile_step("families", train, ops=("aten::einsum", "BmmBackward0"))
    params = init_params(cfg, 7)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (SERVE_BATCH, SERVE_PROMPT)))
    paths["granite-moe generate"] = _generate_run(
        "families", cfg, params, prompt, MAX_LEN, SERVE_NEW)
    _profile_decode(cfg, params, prompt, phase="families")
    del params
    torch.cuda.empty_cache()

    _engine_small("glm4-9b", phase="families", sliding_window=16)
    for name in ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b"):
        _engine_small(name, phase="families", moe_dispatch="dense",
                      moe_capacity_factor=8.0)
    log("families", seconds=time.perf_counter() - t_phase)
    return paths


# ---------------------------------------------------------------------- #
# phase 17: the last two families, xLSTM and Whisper
# ---------------------------------------------------------------------- #
# xLSTM trains at seq 256 (one mLSTM chunk; its prefill of 1024 tokens
# runs four): on an H100 a step at 512 took 20.4 s, ~690k kernels, most
# of them the sLSTM's per-token loop; and at 8 of its 48 layers (one
# unit): at 48 its profiled step took 75 s of the smoke's 1200 (351k
# kernels), at 16 ~30 s. It serves at 48.
XLSTM_SEQ, WHISPER_SEQ = 256, 448
XLSTM_TRAIN_LAYERS = 8      # one unit (the smoke's time limit)


def _paged_from_dense(cfg, dense, page_size: int):
    """A paged cache holding a dense audio cache's rows: slot b's self K/V
    rows in pool pages b * P .. b * P + P - 1 (P = max_len / page_size),
    the cross K/V (dense per slot in both layouts) and ``cross_len`` as
    they are."""
    import torch
    from repro_torch.models import init_paged_cache
    b, max_len = dense["units"]["self"]["k"].shape[1:3]
    p_tab = max_len // page_size
    paged = init_paged_cache(cfg, b, max_len, page_size=page_size,
                             n_pages=b * p_tab)
    for key in ("k", "v"):
        rows = dense["units"]["self"][key]          # (U, B, max_len, H, D)
        paged["units"]["self"][key][:, :b * p_tab] = rows.reshape(
            (rows.shape[0], b * p_tab, page_size) + rows.shape[3:])
        paged["units"]["cross"][key].copy_(dense["units"]["cross"][key])
    paged["pages"].copy_(torch.arange(b * p_tab, dtype=torch.int32,
                                      device="cuda").reshape(b, p_tab))
    paged["index"] = dense["index"].clone()
    paged["cross_len"] = dense["cross_len"]
    return paged


def _whisper_small(phase: str) -> dict:
    """whisper-tiny reduced, f32, on the card: decode over a paged self
    K/V == over the dense cache and ``generate``'s scan == eager, both
    bitwise; frames of 50 rows (``cross_len`` 50 of 64). Launches exact:
    each decode step one paged decode (self) and one linear decode
    (cross) a decoder layer."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.model import prefill_cache_whisper
    cfg = dataclasses.replace(get_config("whisper-tiny").reduced(),
                              dtype="float32")
    params = init_params(cfg, 2)
    rng = np.random.default_rng(4)
    frames = torch.as_tensor(rng.standard_normal(
        (2, 50, cfg.d_model)) * 0.02, dtype=torch.float32, device="cuda")
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 7)),
                             device="cuda")
    dense = prefill_cache_whisper(cfg, params, frames, 2, 64)
    _, dense = prefill(cfg, params, dense, prompt)
    paged = _paged_from_dense(cfg, dense, 16)
    tok, same, steps = prompt[:, -1:], True, 6
    _reset_all()
    for _ in range(steps):
        ld, dense = decode_step(cfg, params, dense, tok)
        lp, paged = decode_step(cfg, params, paged, tok)
        same = same and torch.equal(lp, ld)
        tok = torch.argmax(ld[:, -1:], dim=-1)
    # a step: each layer's self and cross decode over the dense cache, and
    # over the paged one its paged self decode and linear cross decode
    launches = _expect_launches(f"{phase} whisper reduced decode", {
        "flash_decode": 3 * cfg.n_layers * steps,
        "flash_decode_paged": cfg.n_layers * steps})
    kw = dict(max_new_tokens=12, max_len=64, frames=frames)
    scan = serve.generate(cfg, params, prompt, engine="scan", **kw)
    eager = serve.generate(cfg, params, prompt, engine="eager", **kw)
    row = {"config": f"{cfg.name}, float32", "cross_len": dense["cross_len"],
           "paged_equals_dense": same, "decode_steps": steps,
           "launches": launches,
           "scan_equals_eager": bool(torch.equal(scan, eager))}
    log(phase, small=True, **row)
    if not (same and row["scan_equals_eager"]):
        raise AssertionError(f"{phase}: whisper (reduced, f32) identities "
                             f"fail {row}")
    return launches


def phase_xlstm_whisper():
    """The last two families at full published width, bf16: (a)
    xlstm-1.3b: at 8 of its 48 layers through ``ScheduleExecutor`` at
    B 4, seq 256, s = 2, one warm-up and two timed steps, the last of
    them profiled; at all 48 through ``generate`` at batch 4, 1024-token
    prompts
    (four chunks), 16 tokens, and a decode profile; no kernel launched
    anywhere (the reference has none for xLSTM). (b) whisper-tiny, 4 + 4
    layers: through the executor with frames (8, 1500, 384), decoder seq
    448, B 8, s = 2 (24 flash forwards and 12 each of dQ and dK/dV a
    micro-batch); ``generate`` at batch 4, 16-token prompts, 16 tokens,
    max_len 448 (12 forwards a prefill, 8 decodes a step). (c) reduced
    f32: the xLSTM engine == solo with more requests than slots; Whisper
    paged == dense and scan == eager."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count
    t_phase = time.perf_counter()
    paths = {}
    rng = np.random.default_rng(8)

    cfg = get_config("xlstm-1.3b")
    log("xlstm_whisper", config=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads, mlstm_head_dim=(
            cfg.d_inner // cfg.n_heads), slstm_every=cfg.slstm_every,
        dtype=cfg.dtype,
        reduced=f"training seq {XLSTM_SEQ} (one mLSTM chunk) where the "
                f"other training paths take {SEQ}: the sLSTM's per-token "
                f"loop; training at {XLSTM_TRAIN_LAYERS} of "
                f"{cfg.n_layers} layers (the profiler's cost); width as "
                f"published, serving at full depth")
    paths[f"xlstm-1.3b@{XLSTM_TRAIN_LAYERS} executor"] = _executor_steps(
        "xlstm_whisper", "xlstm", dataclasses.replace(
            cfg, n_layers=XLSTM_TRAIN_LAYERS), ((None, 3),), batch=BATCH,
        seq=XLSTM_SEQ, sub_batch=2, profile_last=True)
    params = init_params(cfg, 8)
    log("xlstm_whisper", config=cfg.name, params=param_count(params))
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (SERVE_BATCH, SERVE_PROMPT)))
    paths["xlstm-1.3b generate"] = _generate_run(
        "xlstm_whisper", cfg, params, prompt, MAX_LEN, SERVE_NEW)
    _profile_decode(cfg, params, prompt, phase="xlstm_whisper")
    del params
    torch.cuda.empty_cache()

    cfg = get_config("whisper-tiny")
    log("xlstm_whisper", config=cfg.name, encoder_layers=cfg.encoder_layers,
        decoder_layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, head_dim=cfg.head_dim,
        encoder_seq=cfg.encoder_seq, decoder_seq=WHISPER_SEQ,
        dtype=cfg.dtype, reduced="nothing")
    paths["whisper-tiny executor"] = _executor_steps(
        "xlstm_whisper", "whisper", cfg, ((None, 3),), batch=8,
        seq=WHISPER_SEQ, sub_batch=4)
    params = init_params(cfg, 9)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (SERVE_BATCH, 16)))
    frames = torch.as_tensor(rng.standard_normal(
        (SERVE_BATCH, cfg.encoder_seq, cfg.d_model)) * 0.02,
        dtype=torch.bfloat16, device="cuda")
    paths["whisper-tiny generate"] = _generate_run(
        "xlstm_whisper", cfg, params, prompt, WHISPER_SEQ, SERVE_NEW,
        frames=frames)
    del params
    torch.cuda.empty_cache()

    _engine_small("xlstm-1.3b", phase="xlstm_whisper")
    paths["whisper-tiny reduced decode"] = _whisper_small("xlstm_whisper")
    log("xlstm_whisper", seconds=time.perf_counter() - t_phase)
    return paths


# ---------------------------------------------------------------------- #
# phase 14: autotuning
# ---------------------------------------------------------------------- #
def _forced_table(split: int) -> dict:
    """A table for this card that gives every decode call ``split``: one
    linear entry per (head_dim, dtype); every other decode class takes
    its pair's split."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_decode as fd
    return {"version": autotune.AUTOTUNE_VERSION, "created": time.time(),
            "meta": {"backend": "cuda",
                     "device_name": torch.cuda.get_device_name(0),
                     "forced_split": split},
            "entries": {autotune.shape_key("flash_decode", 4096, d, dt): {
                "backend": "kernel", "split": split}
                for d in fd.HEAD_DIMS for dt in (torch.bfloat16,
                                                 torch.float32)}}


# a re-timed tuned split may be this much slower than 256 and still pass
# (the device's spread between two timings of one call on an H100)
SPLIT_CONFIRM_TOL = 0.01
SPLIT_CONFIRM_ITERS = 50


def _confirm_splits(splits: dict) -> dict:
    """Each (head_dim, dtype) whose tuned split is not 256, timed afresh
    after the choice (``SPLIT_CONFIRM_ITERS`` calls a candidate, queued
    as the sweep queues them) on every linear and paged class of the
    pair: the summed ms at the tuned split and at 256."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_decode as fd
    out = {}
    for (d, name), sp in splits.items():
        if sp == fd.SPLIT:
            continue
        dev = torch.device("cuda")
        with torch.no_grad():
            rec = autotune._tune_flash_decode(
                [c for c in autotune.DECODE_CLASSES if c[1] == d],
                SPLIT_CONFIRM_ITERS, dev)
            rec.update(autotune._tune_flash_decode_paged(
                [c for c in autotune.PAGED_DECODE_CLASSES if c[1] == d],
                autotune.PAGED_CAPACITY, SPLIT_CONFIRM_ITERS, dev))
        t = {want: sum(r["t"] for c in rec.values() for r in c["rows"]
                       if r.get("split") == want) * 1e3
             for want in (sp, fd.SPLIT)}
        out[f"d{d}|{name}"] = {"split": sp, "classes": sorted(rec),
                               "tuned_ms": t[sp], "default_ms": t[fd.SPLIT],
                               "tuned_over_default": t[sp] / t[fd.SPLIT]}
    return out


def _resolve_us(table) -> dict:
    """Host microseconds of one ``ops._resolve`` for a decode call (what
    every decode call adds before its launch), with no table and with
    ``table`` installed."""
    import torch
    from repro_torch.kernels import autotune, ops
    dev = torch.device("cuda")
    out = {}
    for label, t in (("none", None), ("tuned", table)):
        autotune.set_table(t)
        ops._resolve("flash_decode", 4096, 112, torch.bfloat16,
                     {"split": None}, dev)
        n = 20000
        t0 = time.perf_counter()
        for _ in range(n):
            ops._resolve("flash_decode", 4096, 112, torch.bfloat16,
                         {"split": None}, dev)
        out[label] = (time.perf_counter() - t0) / n * 1e6
    autotune.set_table(None)
    return out


def _decode_bound_ms(shape) -> float:
    """The least time of a decode class at the H100's memory rate: each
    slot's K and V rows up to its length (bf16) read once, q read and
    the output written once."""
    from repro_torch.launch.mesh import HBM_BW
    kv = sum(shape["lengths"]) * shape["h_kv"] * shape["d"] * 2 * 2
    qo = 2 * shape["b"] * shape["h"] * shape["d"] * 2
    return (kv + qo) / HBM_BW * 1e3


def phase_autotune():
    """The sweep of ``kernels/autotune.py`` on the card into a temporary
    table; each class's winner and times. Gate: every (head_dim, dtype)
    whose split the sweep moved off 256, timed afresh on its classes, is
    no slower at the tuned split than at 256 (within
    ``SPLIT_CONFIRM_TOL``). The host cost of ``ops._resolve`` with and
    without the table. Under the installed table: every split candidate
    (128, 256, 512) against the plain decode version, linear and paged,
    at head_dim 64 / 112 / 128 / 160 in bf16 and f32; ``ops``' decode
    takes the tuned split; then the reduced f32 engines' identities
    (paged == dense, engine == solo, prefix-shared == private) with
    prompts spanning several splits, bitwise, under the tuned table and
    under tables forced to split 128 and 512. Ends with no table
    installed; returns the table's payload for ``hybrid_serve``'s decode
    step with and without it."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import flash_decode as fd
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    try:
        table, bench = autotune.run_autotune(device="cuda")
        path = autotune.save_artifact(
            table, os.path.join(tmp, "autotune_cuda.json"))
        sweep_s = table["meta"]["seconds"]
        classes = {}
        for key, e in table["entries"].items():
            rows = bench["sweep"][key]["rows"]
            field = "t" if "t" in rows[0] else "t_fwd_bwd"
            classes[key] = {
                "winner": {k: e[k] for k in ("split",) if k in e},
                "t_best_ms": e["t_best"] * 1e3,
                "t_default_ms": e["t_default"] * 1e3,
                "t_ref_ms": e["t_ref"] * 1e3,
                "t_lib_ms": None if e["t_lib"] is None else e["t_lib"] * 1e3,
                "speedup_vs_default": e["speedup_vs_default"],
                "candidates_ms": {
                    str(r.get("split", "kernel")): r[field] * 1e3
                    for r in rows if r["backend"] == "kernel"},
                "shape": bench["sweep"][key]["shape"]}
            if key.startswith("flash_decode"):
                classes[key]["bound_ms"] = _decode_bound_ms(
                    classes[key]["shape"])
                classes[key]["bound_by"] = "bytes"
            log("autotune", cls=key, **classes[key])
        log("autotune", sweep_seconds=sweep_s,
            decode_splits=bench["decode_splits"], meta=table["meta"])
        confirm = _confirm_splits(autotune.choose_decode_splits(
            {k: v for k, v in bench["sweep"].items()
             if k.startswith("flash_decode")}))
        log("autotune", confirmed_splits=confirm)
        slow = {k: c for k, c in confirm.items()
                if not c["tuned_over_default"] <= 1 + SPLIT_CONFIRM_TOL}
        if slow:
            raise AssertionError(f"autotune: tuned splits slower than 256 "
                                 f"when timed again: {slow}")
        tuned = autotune.AutotuneTable(autotune.load_artifact(path))
        resolve_us = _resolve_us(tuned)
        log("autotune", resolve_us=resolve_us)
        autotune.set_table(tuned)
        # every split against the plain version, linear and paged
        split_errs = {}
        for d, h, h_kv in ((64, 8, 8), (112, 8, 8), (128, 12, 2),
                           (160, 32, 8)):
            for dt in (torch.bfloat16, torch.float32):
                for sp in fd.SPLITS:
                    errs = decode_case(f"split {sp}", 4, h, h_kv, 1300, d,
                                       dt, [0, 1300, 777, 1], False,
                                       split=sp, phase="autotune")
                    worst = split_errs.setdefault(str(sp), {})
                    for n, e in errs.items():
                        worst[n] = max(worst.get(n, 0.0), e)
        # ops' decode takes the table's split, whatever the capacity
        gen = torch.Generator(device="cuda")
        gen.manual_seed(11)
        route = {}
        for d in fd.HEAD_DIMS:
            lengths = torch.tensor([1300, 5, 1000], device="cuda")
            q, k, v, (kp, vp), pages = _decode_inputs(
                gen, 3, 8, 2, 1300, d, torch.bfloat16, lengths, 16)
            sp = tuned.lookup("flash_decode", 1300, d, torch.bfloat16,
                              "cuda")["split"]
            route[d] = {"split": sp, "linear": bool(torch.equal(
                ops.flash_decode(q, k, v, lengths),
                fd.flash_decode(q, k, v, lengths, split=sp))),
                "paged": bool(torch.equal(
                    ops.flash_decode_paged(q, kp, vp, pages, lengths),
                    fd.flash_decode_paged(q, kp, vp, pages, lengths,
                                          split=sp)))}
        log("autotune", ops_decode_takes_the_tuned_split=route)
        if not all(r["linear"] and r["paged"] for r in route.values()):
            raise AssertionError(f"autotune: ops' decode is not the tuned "
                                 f"split: {route}")
        # the engines' identities under the tuned table and forced splits
        identities = {}
        for label, payload in (("tuned", None),
                               ("split 128", _forced_table(128)),
                               ("split 512", _forced_table(512))):
            if payload is not None:
                autotune.set_table(autotune.AutotuneTable(payload))
            entry = autotune.lookup("flash_decode", 1280, 64,
                                    torch.float32, "cuda")
            took = (entry or autotune.DEFAULTS["flash_decode"])["split"]
            row = _engine_small(phase="autotune", long=True)
            identities[label] = {"split": took, "engine_vs_solo":
                                 row["engine_vs_solo"]["identical"],
                                 "paged_vs_dense":
                                 row["paged_vs_dense"]["identical"],
                                 "prefix_shared_vs_private":
                                 row["prefix_shared_vs_private"]["identical"],
                                 "of": row["requests"]}
        log("autotune", identities=identities)
    finally:
        autotune.set_table(None)
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log("autotune", seconds=seconds)
    return {"decode_splits": bench["decode_splits"],
            "candidates": list(fd.SPLITS), "classes": classes,
            "max_row_rel_err_by_split": split_errs, "confirmed": confirm,
            "resolve_us": resolve_us, "identities": identities,
            "sweep_seconds": sweep_s, "seconds": seconds, "table": table}


# ---------------------------------------------------------------------- #
# phase 18: the fleet
# ---------------------------------------------------------------------- #
FLEET_BATCH = 4
# checkpoint_every of the fleet runs without and with the kill: at the end
# of each lease only, and after every second step of a job too (writes
# the kill, on a heartbeat once a0 has stepped twice, may cut into)
FLEET_CKPT_EVERY = (0, 2)


def _fleet_plan():
    """The reference fleet test's replay plan (``tests/test_fleet.py``
    ``_replay_plan``) through the port's simulator copy: donor A spans
    both GPUs, B and C form a 3-way sharing group with donor
    reconfigurations, D queues; 8 phases, 16 steps."""
    from repro_torch.core import (ClusterState, InterferenceModel, Job,
                                  PerfParams, Simulator)
    from repro_torch.core.schedulers import SJF_BSBF
    from repro_torch.launch.cluster import plan_from_sim
    gb = 2 ** 30

    def perf(beta):
        return PerfParams(alpha_comp=0.01, beta_comp=beta, alpha_comm=0.0,
                          beta_comm=0.0, msg_bytes=0.0, delta=2.0,
                          mem_base=4.0 * gb, mem_per_sample=0.25 * gb,
                          param_bytes=1e8, n_workers=1)
    pa, pb = perf(0.01), perf(0.008)
    t_a = pa.t_iter(4)
    jobs = [Job(jid=0, model="m0", arrival=0.0, gpus=2, iters=6.0, batch=4,
                perf=pa),
            Job(jid=1, model="m1", arrival=2 * t_a, gpus=1, iters=3.0,
                batch=4, perf=pb),
            Job(jid=2, model="m1", arrival=4 * t_a, gpus=1, iters=4.0,
                batch=4, perf=pb),
            Job(jid=3, model="m0", arrival=6 * t_a, gpus=1, iters=3.0,
                batch=4, perf=pa)]
    cap = pa.mem_bytes(2) + pb.mem_bytes(2) + 0.25 * 0.25 * gb
    interf = InterferenceModel()
    for a in ("m0", "m1"):
        for b in ("m0", "m1"):
            interf.set_pair(a, b, 1.3, 1.3)
    sim = Simulator(ClusterState(n_servers=1, gpus_per_server=2,
                                 gpu_capacity_bytes=cap),
                    jobs, SJF_BSBF(donor_reconfig=True), interference=interf,
                    reconfig_on_release=True)
    sim.run()
    return plan_from_sim(sim.log, sim.jobs, sim.interference, cap,
                         names={0: "A", 1: "B", 2: "C", 3: "D"})


def _lease_lines(ckdir: str) -> list:
    """The per-lease JSON lines the agents printed to their logs."""
    out = []
    for name in sorted(os.listdir(ckdir)):
        if name.endswith(".log"):
            with open(os.path.join(ckdir, name)) as f:
                out += [json.loads(ln) for ln in f
                        if ln.startswith('{"agent"')]
    return out


def phase_fleet():
    """whisper-tiny at full size (4 + 4 layers, 1500 frames, decoder seq
    448, bf16), seeds 0-3, on the fleet test's replay plan: the
    single-host ``ScheduleExecutor`` (each job checkpointed as it
    finishes, before the executor releases its state), then a master
    with 2 agent processes sharing this card (a checkpoint at the end of
    each lease), then the same with agent a0 SIGKILLed once it has
    stepped twice (a checkpoint after every second step too). The first
    master's agents start first, so their start (importing torch takes
    seconds) overlaps the single-host run, and the second's as the first
    run begins. Every job finishes with
    the single-host steps, loss and checkpoint CRC, exactly; in the
    killed run a0's death is detected under ``dead_after`` + 1 s and its
    lease re-dispatched; without the kill the agents' flash launches add
    up to the single host's. Prints each lease's seconds, peak memory
    and launches."""
    import contextlib
    import shutil
    import torch
    from repro_torch.checkpoint import checkpoint_crc
    from repro_torch.configs import get_config
    from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
    from repro_torch.launch.fleet import (ChaosKiller, FleetConfig,
                                          FleetMaster, KillSpec)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()          # room for the agents' own contexts
    cfg = get_config("whisper-tiny")
    specs = {n: JobSpec(cfg, batch=FLEET_BATCH, seq=WHISPER_SEQ, seed=i)
             for i, n in enumerate("ABCD")}
    plan = _fleet_plan()
    totals = {}
    for ph in plan.phases:
        for name, q in ph.quotas:
            totals[name] = totals.get(name, 0) + q
    log("fleet", config=cfg.name, batch=FLEET_BATCH, decoder_seq=WHISPER_SEQ,
        encoder_seq=cfg.encoder_seq, dtype=cfg.dtype, reduced="nothing",
        phases=len(plan.phases), steps=totals,
        groups=max(len(g) for ph in plan.phases for g in ph.groups),
        checkpoint_every=FLEET_CKPT_EVERY)

    class FinalCheckpoints(ScheduleExecutor):
        def finish(self, name):
            self.checkpoint(name)
            return super().finish(name)

    root = _checkpoint_dir(16 * 10 ** 9)
    paths = {}
    runs = (("fleet", FleetConfig(checkpoint_every=FLEET_CKPT_EVERY[0]),
             None),
            ("fleet, a0 SIGKILLed", FleetConfig(
                checkpoint_every=FLEET_CKPT_EVERY[1], step_sleep=0.3,
                heartbeat_interval=0.1, suspect_after=0.5, dead_after=1.0),
             ChaosKiller([KillSpec(agent="a0", after_steps=2)])))

    def spawn(m) -> float:
        for _ in range(2):
            m.spawn_agent()
        return time.perf_counter()

    try:
        with contextlib.ExitStack() as stack:
            masters = []
            for i, (label, fcfg, chaos) in enumerate(runs):
                m = stack.enter_context(FleetMaster(
                    os.path.join(root, f"fleet{i}"), config=fcfg,
                    chaos=chaos))
                m.start(0)
                masters.append(m)
            # the first run's agents start beside the single host; each
            # next run's while the run before it goes (importing torch
            # takes seconds; four at once took 25 s)
            spawned = [spawn(masters[0])]
            ref_dir = os.path.join(root, "single_host")
            os.makedirs(ref_dir)
            _reset_all()
            t1 = time.perf_counter()
            with FinalCheckpoints(checkpoint_dir=ref_dir) as ex:
                for name, spec in specs.items():
                    ex.submit(name, spec, totals[name])
                ref = ex.execute(plan)
            single_s = time.perf_counter() - t1
            paths["single host"] = _launches()
            files = {n: os.path.join(ref_dir, f"{n}.npz") for n in specs}
            crcs = {n: checkpoint_crc(p) for n, p in files.items()}
            log("fleet", run="single host", seconds=single_s,
                steps={n: r["steps"] for n, r in ref.items()},
                loss={n: r["loss"] for n, r in ref.items()}, crc=crcs,
                checkpoint_bytes=os.path.getsize(files["A"]),
                checkpoints=ex.checkpoints_written,
                launches=paths["single host"])
            shutil.rmtree(ref_dir)
            for i, (m, (label, fcfg, chaos)) in enumerate(zip(masters,
                                                              runs)):
                m.wait_for_agents(2)
                t1 = time.perf_counter()
                if i + 1 < len(masters):
                    spawned.append(spawn(masters[i + 1]))
                rep = m.run_plan(plan, specs)
                seconds = time.perf_counter() - t1
                m.shutdown()
                _fleet_run(label, m, fcfg, chaos, rep, ref, crcs, seconds,
                           agents_up=t1 - spawned[i], paths=paths)
                shutil.rmtree(m.checkpoint_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("fleet", seconds=time.perf_counter() - t_phase)
    return paths


def _fleet_run(label, m, fcfg, chaos, rep, ref, crcs, seconds, agents_up,
               paths) -> None:
    """One fleet run's row and gates (see ``phase_fleet``)."""
    leases = _lease_lines(m.checkpoint_dir)
    launches = {}
    for ln in leases:
        for k, n in ln["launches"].items():
            launches[k] = launches.get(k, 0) + n
    paths[f"{label}, agents"] = launches
    dead = [e for e in m.events if e["kind"] == "agent_dead"]
    row = {"run": label, "seconds": seconds,
           "agents_up_after_seconds": agents_up,
           "checkpoint_every": fcfg.checkpoint_every,
           "steps": {n: r["steps"] for n, r in rep.items()},
           "loss_equal": {n: rep[n]["loss"] == ref[n]["loss"] for n in ref},
           "crc_equal": {n: rep[n]["crc"] == crcs[n] for n in ref},
           "redispatches": m.stats["redispatches"],
           "fenced": m.stats["fenced"], "steps_lost": m.stats["steps_lost"],
           "agent_dead": [{k: e[k] for k in (
               "agent", "reason", "detection_latency", "killed")}
               for e in dead],
           "leases": [{k: ln[k] for k in (
               "agent", "lease", "members", "seconds", "walltime",
               "peak_bytes", "launches")} for ln in leases],
           "peak_bytes_by_agent": {
               a: max(ln["peak_bytes"] or 0 for ln in leases
                      if ln["agent"] == a)
               for a in sorted({ln["agent"] for ln in leases})},
           "launches": launches}
    log("fleet", **row)
    bad = [n for n in ref
           if not (rep[n]["finished"] and rep[n]["steps"] == ref[n]["steps"]
                   and row["loss_equal"][n] and row["crc_equal"][n])]
    if bad:
        raise AssertionError(f"fleet: {label}: jobs {bad} differ from the "
                             "single host")
    if chaos is None:
        if launches != paths["single host"]:
            raise AssertionError(f"fleet: agents launched {launches}, the "
                                 f"single host {paths['single host']}")
    elif not (len(chaos.kills) == 1 and dead and dead[0]["agent"] == "a0"
              and dead[0]["killed"]
              and dead[0]["detection_latency"] < fcfg.dead_after + 1.0
              and m.stats["redispatches"] >= 1):
        raise AssertionError(f"fleet: the kill was not detected and "
                             f"recovered: {row}")


# ---------------------------------------------------------------------- #
# phase 19: sharded training on a (1, 1) mesh, and the dry-run
# ---------------------------------------------------------------------- #
# the dry-run's processes: (arch, shape, extra flags); minicpm-2b on both
# meshes, and one record of each architecture whose catalogue entry
# failed before its repair (the MoE experts on DTensors, zamba2-7b's conv
# and SSD chunks, xlstm-1.3b's sLSTM state and loops, llama3-405b's 16
# micro-batches), at the shape that shows the fix
DRYRUN_RUNS = (("minicpm-2b", "train_4k", ["--both-meshes"]),
               ("qwen2-vl-2b", "train_4k", []),
               ("llama4-maverick-400b-a17b", "prefill_32k", []),
               ("zamba2-7b", "prefill_32k", []),
               ("xlstm-1.3b", "train_4k", []),
               ("xlstm-1.3b", "decode_32k", []),
               ("llama3-405b", "train_4k", []))
DRYRUN_RECORDS = (("minicpm-2b", "train_4k", "16x16"),
                  ("minicpm-2b", "train_4k", "2x16x16"),
                  ("qwen2-vl-2b", "train_4k", "16x16"),
                  ("llama4-maverick-400b-a17b", "prefill_32k", "16x16"),
                  ("zamba2-7b", "prefill_32k", "16x16"),
                  ("xlstm-1.3b", "train_4k", "16x16"),
                  ("xlstm-1.3b", "decode_32k", "16x16"),
                  ("llama3-405b", "train_4k", "16x16"))
DRYRUN_TIME_LIMIT_S = 300       # a record's host seconds (--time-limit)
DRYRUN_TIMEOUT_S = 600          # all of them, from their start
DRYRUN_NICE = 19                # below the smoke's own process


def _start_dryrun(out_dir: str) -> list:
    """The dry-run's processes on the host, started together at the
    lowest CPU priority (they share the host with the timed phases):
    each traces its records and writes them to its own file."""
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = []
    for arch, shape, flags in DRYRUN_RUNS:
        out = os.path.join(out_dir, f"{arch}_{shape}.json")
        log_f = open(os.path.join(out_dir, f"{arch}_{shape}.log"), "w")
        procs.append((out, log_f, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--time-limit",
             str(DRYRUN_TIME_LIMIT_S), "--out", out] + flags,
            stdout=log_f, stderr=subprocess.STDOUT, env=env,
            preexec_fn=lambda: os.nice(DRYRUN_NICE))))
    return procs


def _finish_dryrun(procs, t_end: float) -> list:
    """Wait for the dry-run's processes (until ``t_end``) and return
    their records (``main`` kills any still running)."""
    records = []
    for out, log_f, proc in procs:
        rc = proc.wait(timeout=max(t_end - time.perf_counter(), 1.0))
        log_f.close()
        if rc != 0:
            with open(log_f.name) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"sharded: dry-run exited {rc}: {tail}")
        with open(out) as f:
            records += json.load(f)
    return records


def phase_sharded(base, dry):
    """(a) ``launch.train`` as phase ``train`` ran it (minicpm-2b at full
    width and ``TRAIN_LAYERS`` of its layers, bf16, B 4, seq 2048, accum
    2, 3 steps, with a checkpoint), now with ``--distributed``: an
    ``nccl`` world of one that ``launch.train`` starts and destroys, a
    (1, 1) ('data', 'model') mesh over the card, every parameter a DTensor
    at its plan's placements, the flash kernels launched through
    ``local_map`` on the local blocks. Required: every parameter at its
    placements; the per-step losses and the checkpoint's CRC those of
    phase ``train``'s run, bitwise; the flash launches equal to that
    run's. Prints both runs' seconds a step (DTensor's host cost on a
    1 x 1 mesh) and peak memory. (b) The dry-run on the host, in ``dry``:
    (processes, their start) from ``_start_dryrun``, started before phase
    ``families`` at the lowest priority, so that they end before the
    sharded steps (started after them, they would add their ~110 s to the
    smoke's 1200; beside ``families``, ``xlstm_whisper`` and ``fleet``
    they moved none of those phases' readings past the runs' own spread,
    PERF.md §6): ``DRYRUN_RECORDS`` (minicpm-2b at train_4k on 16 x 16 and
    2 x 16 x 16, qwen2-vl-2b on 16 x 16, and on 16 x 16 llama4-maverick's
    and zamba2-7b's prefill_32k, xlstm-1.3b's train_4k and decode_32k,
    llama3-405b's train_4k). Required: each record ``ok``. Prints each
    record's host seconds, per-device FLOPs, collective bytes by kind,
    argument and temporary bytes against this card's memory, the loop
    trips counted from an identical one, and the roofline terms at the
    H100's rates; and how long the phase waited for them."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import checkpoint_crc
    from repro_torch.launch import specs, train
    from repro_torch.launch.mesh import CARD, hbm_capacity
    from repro_torch.sharding.rules import make_rules
    from repro_torch.tree import flatten
    t_phase = time.perf_counter()
    procs, t_dry = dry
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_all()
    ckdir = _checkpoint_dir(TRAIN_CKPT_BYTES)
    try:
        path = os.path.join(ckdir, "sharded.npz")
        t0 = time.perf_counter()
        with _train_depth():
            res = train.run(TRAIN_ARGS + ["--distributed", "--checkpoint",
                                          path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        crc = checkpoint_crc(path)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = _launches()
    if dist.is_initialized():
        raise AssertionError("sharded: the driver left its group")
    want = flatten(specs.param_shardings(make_rules(res.mesh),
                                         res.params))
    off_plan = [k for k, t in flatten(res.params).items()
                if not isinstance(t, DTensor)
                or tuple(t.placements) != tuple(want[k])]
    mesh_shape = list(res.mesh.shape)
    losses, s_step = res.losses, res.loop_seconds / len(res.losses)
    del res
    torch.cuda.empty_cache()
    row = {"run": "launch.train --distributed",
           "args": " ".join(TRAIN_ARGS + ["--distributed"]),
           "mesh": mesh_shape, "params_off_plan": off_plan,
           "losses": losses, "losses_unsharded": base["losses"],
           "losses_equal": losses == base["losses"],
           "loss_diff": [a - b for a, b in zip(losses,
                                                base["losses"])],
           "crc": crc, "crc_unsharded": base["crc"],
           "crc_equal": crc == base["crc"],
           "s_per_step": s_step,
           "s_per_step_unsharded": base["s_per_step"],
           "host_cost_s_per_step": s_step - base["s_per_step"],
           "wall_s_with_init_and_checkpoint": wall,
           "max_memory_allocated_gb": peak_gb,
           "max_memory_allocated_gb_unsharded":
               base["max_memory_allocated_gb"],
           "launches": launches, "launches_unsharded": base["launches"]}
    log("sharded", **row)
    if off_plan:
        raise AssertionError(f"sharded: parameters off their plan: "
                             f"{off_plan[:5]}")
    if mesh_shape != [1, 1]:
        raise AssertionError(f"sharded: mesh {mesh_shape}, not (1, 1)")
    if launches != base["launches"] or not all(
            launches[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkdv")):
        raise AssertionError(f"sharded: launches {launches} against "
                             f"{base['launches']}")
    if not (row["losses_equal"] and row["crc_equal"]):
        raise AssertionError("sharded: the sharded run parts from the "
                             f"unsharded one: {row}")
    t_wait = time.perf_counter()
    records = _finish_dryrun(procs, t_dry + DRYRUN_TIMEOUT_S)
    log("sharded", dryrun_wait_s=time.perf_counter() - t_wait,
        dryrun_s_since_start=time.perf_counter() - t_dry)
    cap = hbm_capacity()
    got = {(r["arch"], r["shape"], r["mesh"]): r for r in records}
    for key in DRYRUN_RECORDS:
        r = got.get(key)
        if r is None or r["status"] != "ok":
            raise AssertionError(f"sharded: dry-run {key}: {r}")
        mem = r["memory_analysis"]
        log("sharded", dryrun=" x ".join(key),
            status=r["status"], n_devices=r["n_devices"],
            accum_steps=r["accum_steps"],
            host_seconds_trace=r["seconds_trace"],
            loop_trips_not_run=r["loop_trips_not_run"],
            flops_per_device=r["flops_per_device"],
            bytes_per_device=r["bytes_per_device"],
            collective_bytes_per_device=r["collective_bytes_per_device"],
            n_collectives={k: r[k] for k in (
                "n_allgather", "n_allreduce", "n_reducescatter",
                "n_alltoall", "n_collectivepermute")},
            argument_bytes=mem["argument_bytes"],
            temp_bytes=mem["temp_bytes"], hbm_capacity_bytes=cap,
            fits=mem["argument_bytes"] + mem["temp_bytes"] <= cap,
            roofline={k: r["roofline"][k] for k in (
                "compute_s", "memory_s", "collective_s", "dominant")},
            rates_card=CARD)
    log("sharded", seconds=time.perf_counter() - t_phase)
    return launches


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
    from repro_torch.kernels import autotune
    # every phase runs the kernels' defaults (no table installed), as the
    # smoke did before there was a table; ``autotune`` installs its own
    # and ``hybrid_serve`` compares one decode run under it
    autotune.set_table(None)
    t0 = time.perf_counter()
    seconds = {}

    def run(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__[6:]] = time.perf_counter() - t
        return out

    run(phase_build)
    errs, timing = run(phase_parity)
    launches = dict(run(phase_solo))
    run(phase_pair)
    launches_calibrate = run(phase_calibrate)
    launches_replay = run(phase_replay)
    run(phase_policies)
    launches_recovery = run(phase_recovery)
    launches_train, train_base = run(phase_train)
    run(phase_profile)
    hybrid = run(phase_hybrid)
    launches.update(ssd_fwd=hybrid["ssd_fwd"], ssd_bwd=hybrid["ssd_bwd"])
    run(phase_accum)
    launches["flash_decode"] = run(phase_serve)["flash_decode"]
    launches["flash_decode_paged"] = run(phase_engine)["flash_decode_paged"]
    tuned = run(phase_autotune)
    serve_paths = run(phase_hybrid_serve, tuned["table"])
    # phase sharded's dry-run traces on the host, at the lowest priority,
    # beside phases families, xlstm_whisper and fleet (~280 s), so that
    # they are done before the sharded steps
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry = (_start_dryrun(dry_dir), time.perf_counter())
    try:
        family_paths = run(phase_families)
        last_paths = run(phase_xlstm_whisper)
        fleet_paths = run(phase_fleet)
        launches_sharded = run(phase_sharded, train_base, dry)
    finally:
        for _, log_f, proc in dry[0]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()
        shutil.rmtree(dry_dir, ignore_errors=True)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd
    # the head dims each kernel's wrapper takes (for the SSD: its head
    # width P)
    head_dims = {"flash_fwd": fa.HEAD_DIMS, "flash_bwd_dq": fa.HEAD_DIMS,
                 "flash_bwd_dkdv": fa.HEAD_DIMS, "flash_decode": fd.HEAD_DIMS,
                 "flash_decode_paged": fd.HEAD_DIMS, "ssd_fwd": ssd.HEAD_DIMS,
                 "ssd_bwd": ssd.HEAD_DIMS}
    kernels = []
    for name in REPLACES:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            # the hybrid-serving path's own counts, each read just after
            # its run
            "launches_hybrid_serve": {
                path: n[name] for path, n in serve_paths.items()
                if n.get(name)}})
        if launches_calibrate.get(name):
            # the calibration and replay paths' own counts
            kernels[-1]["launches_calibrate"] = launches_calibrate[name]
            kernels[-1]["launches_replay"] = {
                path: n[name] for path, n in launches_replay.items()}
        # the recovery and training-driver paths' own counts
        recovery = {path: n[name] for path, n in launches_recovery.items()
                    if n.get(name)}
        if recovery:
            kernels[-1]["launches_recovery"] = recovery
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
            kernels[-1]["launches_train"] = {
                path: n[name] for path, n in launches_train.items()}
        if name in SSD_PASSES:
            kernels[-1].update(
                cuda_kernels=[f"ssd_{p}_kernel" for p in SSD_PASSES[name]],
                bound_3xtf32_ms=t["bound_3xtf32_ms"], passes=t["passes"])
        # the families phase's paths' own counts
        families = {path: n[name] for path, n in family_paths.items()
                    if n.get(name)}
        if families:
            kernels[-1]["launches_families"] = families
        # the xlstm_whisper phase's paths' own counts (every one of them,
        # xLSTM's zeros included)
        kernels[-1]["launches_xlstm_whisper"] = {
            path: n[name] for path, n in last_paths.items()}
        kernels[-1]["head_dims"] = list(head_dims[name])
        if name in DECODE_INSTANCES:
            kernels[-1]["instantiations"] = DECODE_INSTANCES[name]
            # the split variants: candidates, the tuned split per
            # (head_dim, dtype), each class's time by split, each split's
            # largest row error against the plain version
            kind = name + "|"
            kernels[-1]["splits"] = {
                "candidates": tuned["candidates"], "default": fd.SPLIT,
                "tuned": tuned["decode_splits"],
                "confirmed": tuned["confirmed"],
                "classes": {k: {f: c[f] for f in (
                    "candidates_ms", "t_ref_ms", "t_lib_ms", "winner")}
                    for k, c in tuned["classes"].items()
                    if k.startswith(kind)},
                "max_row_rel_err": {
                    sp: e[name] for sp, e in
                    tuned["max_row_rel_err_by_split"].items()}}
        # the fleet phase's counts: the single host in this process, the
        # agents' summed from their per-lease lines
        fleet = {path: n[name] for path, n in fleet_paths.items()
                 if n.get(name)}
        if fleet:
            kernels[-1]["launches_fleet"] = fleet
        if launches_sharded.get(name):
            # the sharded driver's own count (phase ``sharded``)
            kernels[-1]["launches_sharded"] = launches_sharded[name]
        for key in ("at_d112", "at_d160", "at_d160_f32", "ring",
                    "with_state_in_out", "at_cross"):
            if key in t:
                kernels[-1][key] = t[key]
    log("done", seconds=time.perf_counter() - t0, phases=seconds,
        limit_s=1200)
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
