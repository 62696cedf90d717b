"""Algorithm 2 — Batch Size Scaling with Best Sharing Benefit.

Given a running job and a new job that would share the running job's GPUs,
sweep the new job's per-GPU sub-batch b over {B, ceil(B/2), ..., 1}
(gradient accumulation supplies s = ceil(B/b) micro-steps — the final
micro-batch absorbs the remainder when b does not divide B, so the
*effective* batch, and hence convergence, is unchanged for every
candidate), check memory feasibility of the pair, apply Theorem 1 per
candidate, and return the best (SF, b, t_bar).

The port's copy of the reference's ``core/batch_scaling.py``, same
arithmetic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from .interference import InterferenceModel
from .job import Job
from .pair import PairDecision, PairJob, best_pair_schedule, pair_timeline


@dataclass(frozen=True)
class SharingConfig:
    share: bool                 # SF
    sub_batch: int              # b (new job's per-GPU sub-batch)
    accum_steps: int            # s = B / b
    avg_jct: float              # t_bar
    decision: Optional[PairDecision]
    xi_new: float = 1.0
    xi_run: float = 1.0


_CANDIDATES_MEMO: dict = {}


def candidate_sub_batches(batch: int) -> list[int]:
    """B, B/2, ..., 1 (powers-of-two steps, as in Algorithm 2).
    Memoized per batch size (a trace has few distinct batches but every
    arriving job asks); treat the result as read-only."""
    out = _CANDIDATES_MEMO.get(batch)
    if out is not None:
        return out
    out = []
    b = batch
    while b >= 1:
        out.append(int(b))
        if b == 1:
            break
        b = math.ceil(b / 2)
    _CANDIDATES_MEMO[batch] = out
    return out


def best_sharing_config(
    running: Job,
    new: Job,
    interference: InterferenceModel,
    gpu_capacity_bytes: float,
    rem_run: Optional[float] = None,
) -> SharingConfig:
    """Algorithm 2. ``running`` keeps its current sub-batch (the paper does
    not re-tune the running job); only the new job's b is swept.
    ``rem_run`` overrides the donor's remaining iterations (schedulers
    pass the engine's virtual read, ``Simulator.remaining_at``)."""
    run_mem = running.perf.mem_bytes(running.sub_batch)
    t_run = running.solo_t_iter
    if rem_run is None:
        rem_run = running.remaining_iters
    # xi is independent of the candidate sub-batch under a global override
    # or a two-way pair-table hit; only the structural fallback needs the
    # per-candidate timing/memory arguments.
    fixed_xi = interference.pair_fixed(running.model, new.model)
    best: Optional[SharingConfig] = None

    for b in candidate_sub_batches(new.batch):
        s = max(1, math.ceil(new.batch / b))
        new_mem = new.perf.mem_bytes(b)
        if new_mem + run_mem > gpu_capacity_bytes:
            continue  # pair does not fit device memory at this sub-batch
        t_new = new.t_iter_sub(b)
        if fixed_xi is not None:
            xi_run, xi_new = fixed_xi
        else:
            mem_frac = (run_mem + new_mem) / gpu_capacity_bytes
            xi_run = interference.xi(
                running.model, new.model,
                t_me=t_run, t_other=t_new, mem_frac=mem_frac)
            xi_new = interference.xi(
                new.model, running.model,
                t_me=t_new, t_other=t_run, mem_frac=mem_frac)
        a = PairJob(t_iter=t_run, iters=rem_run, xi=xi_run)
        bb = PairJob(t_iter=t_new, iters=new.iters, xi=xi_new)
        dec = best_pair_schedule(a, bb)
        cfg = SharingConfig(
            share=dec.share, sub_batch=b, accum_steps=s,
            avg_jct=dec.avg_jct, decision=dec, xi_new=xi_new, xi_run=xi_run,
        )
        if best is None or cfg.avg_jct < best.avg_jct:
            best = cfg
        if fixed_xi is not None:
            # With b-independent xi the pair-average JCT is monotone
            # nondecreasing as the sub-batch shrinks (t_iter(B, s) grows
            # with s and both Theorem-1 endpoints grow with the new
            # job's iteration time), so the first (largest) feasible
            # sub-batch is optimal — same winner as the full sweep.
            break

    if best is None:
        # No sub-batch fits next to the running job -> cannot share.
        return SharingConfig(False, new.batch, 1, float("inf"), None)
    return best


@dataclass(frozen=True)
class DonorScaledConfig:
    """Result of the donor-rescaling extension: like
    :class:`SharingConfig` plus the DONOR's new sub-batch."""

    share: bool
    donor_sub_batch: int        # running job's new b (its B is unchanged)
    sub_batch: int              # new job's b
    accum_steps: int
    avg_jct: float
    xi_run: float = 1.0
    xi_new: float = 1.0


def best_sharing_config_donor_scaled(
    running: Job,
    new: Job,
    interference: InterferenceModel,
    gpu_capacity_bytes: float,
    rem_run: Optional[float] = None,
) -> DonorScaledConfig:
    """Algorithm-2 extension: when no sub-batch of the
    new job fits beside the donor's *current* footprint, sweep the
    DONOR's sub-batch down too — the donor accepts extra gradient
    accumulation (slower iterations, unchanged effective batch) to make
    memory room for the sharer. This is a mid-run (τ, sub-batch)
    reconfiguration of the running job: the scheduler applies it via
    ``Simulator.reconfigure_job`` at the sharing time point, and the
    executor steps the donor at the new accumulation while carrying its
    params/opt state through.

    The sequential baseline prices the donor at its CURRENT sub-batch
    (declining to share leaves it untouched), so the donor's slowdown is
    charged against the sharing benefit — a pair only shares when the
    benefit survives the reconfiguration cost."""
    if rem_run is None:
        rem_run = running.remaining_iters
    t_run_cur = running.solo_t_iter
    fixed_xi = interference.pair_fixed(running.model, new.model)
    best: Optional[DonorScaledConfig] = None

    for b_run in candidate_sub_batches(running.batch):
        if b_run >= running.sub_batch:
            continue   # only shrinking the donor can unlock memory
        run_mem = running.perf.mem_bytes(b_run)
        t_run = running.t_iter_sub(b_run)
        for b_new in candidate_sub_batches(new.batch):
            new_mem = new.perf.mem_bytes(b_new)
            if run_mem + new_mem > gpu_capacity_bytes:
                continue
            t_new = new.t_iter_sub(b_new)
            if fixed_xi is not None:
                xi_run, xi_new = fixed_xi
            else:
                mem_frac = (run_mem + new_mem) / gpu_capacity_bytes
                xi_run = interference.xi(
                    running.model, new.model,
                    t_me=t_run, t_other=t_new, mem_frac=mem_frac)
                xi_new = interference.xi(
                    new.model, running.model,
                    t_me=t_new, t_other=t_run, mem_frac=mem_frac)
            # share endpoint: both reconfigured, concurrent from kappa=0
            t_a0, t_b0 = pair_timeline(
                PairJob(t_iter=t_run, iters=rem_run, xi=xi_run),
                PairJob(t_iter=t_new, iters=new.iters, xi=xi_new), 0.0)
            avg0 = 0.5 * (t_a0 + t_b0)
            # sequential endpoint: donor untouched at its current b
            t_a1 = rem_run * t_run_cur
            avg1 = 0.5 * (t_a1 + (t_a1 + new.iters * t_new))
            if avg0 > avg1:
                continue   # reconfiguration cost eats the benefit
            cfg = DonorScaledConfig(
                share=True, donor_sub_batch=b_run, sub_batch=b_new,
                accum_steps=max(1, math.ceil(new.batch / b_new)),
                avg_jct=avg0, xi_run=xi_run, xi_new=xi_new)
            if best is None or cfg.avg_jct < best.avg_jct:
                best = cfg
            if fixed_xi is not None:
                # b-independent xi: the largest feasible b_new is optimal
                # for this b_run (same monotonicity as the plain sweep)
                break

    if best is None:
        return DonorScaledConfig(False, running.sub_batch, new.batch, 1,
                                 float("inf"))
    return best
