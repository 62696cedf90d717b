"""Vectorized sharing-decision core — batched Algorithm 2 + Theorem 1
(the port's copy of the reference's ``core/pair_batch.py``, numpy on the
host, same arithmetic).

``core.batch_scaling.best_sharing_config`` evaluates one
(pending, donor) pair at a time: a Python sweep over candidate
sub-batches with a scalar Theorem-1 timeline per candidate. Algorithm 1
calls it once per donor per pending job per scheduling pass, which makes
the *decision layer* the dominant cost at datacenter trace sizes once
the event loop itself is heap-indexed.

This module evaluates one pending job against *all* donors at once:

* per-job candidate tables — sub-batches, accumulation counts,
  iteration times, and memory footprints over the Algorithm-2 candidate
  list — are precomputed once and cached on the :class:`Job`
  (:func:`job_candidate_table`);
* per-donor scalars (memory, solo iteration time, remaining work) are
  packed into a :class:`DonorBatch`, built once per scheduling pass and
  reused across the pending queue until a placement changes the donor
  set;
* the memory-feasibility mask, both Theorem-1 endpoints (the kappa=0
  ``pair_timeline`` and the sequential closed form), and the per-donor
  argmin run as NumPy array ops over the (donor × candidate) grid.

The arithmetic mirrors the scalar reference expression-for-expression
(same IEEE-754 operation order), so decisions and pair-JCT values are
bitwise identical, not merely close.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .batch_scaling import SharingConfig, candidate_sub_batches
from .interference import InterferenceModel
from .job import Job
from .pair import PairDecision

__all__ = [
    "DonorBatch", "DonorDecisions", "best_sharing_config_batched",
    "best_sharing_configs", "job_candidate_table",
]


def job_candidate_table(job: Job) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
    """``(sub_batches, accum_steps, t_iter, mem_bytes)`` arrays over the
    Algorithm-2 candidate list of ``job``, cached on the job (the table
    is a pure function of its batch and perf params). Iteration times
    come from the job's scalar memo so both decision paths share the
    exact same floats."""
    tab = job._pair_table
    if tab is None:
        bs = candidate_sub_batches(job.batch)
        ss = [max(1, math.ceil(job.batch / b)) for b in bs]
        tab = (
            np.array(bs, dtype=np.int64),
            np.array(ss, dtype=np.int64),
            np.array([job.t_iter_sub(b) for b in bs], dtype=np.float64),
            np.array([job.perf.mem_bytes(b) for b in bs], dtype=np.float64),
        )
        job._pair_table = tab
    return tab


class DonorBatch:
    """Array view over a set of donor (running) jobs: memory footprint at
    the current sub-batch, solo iteration time, and remaining
    iterations. Built once per scheduling pass; per-(new-model) xi terms
    are cached on the batch because every pending job of the same model
    sees the same donor-side interference constants."""

    __slots__ = ("donors", "jids", "run_mem", "t_run", "rem_run",
                 "_models", "_codes", "_xi_cache")

    def __init__(self, donors: Sequence[Job], rem_fn=None) -> None:
        self.donors: List[Job] = list(donors)
        jids = []
        run_mem = []
        t_run = []
        rem_run = []
        model_index: dict = {}
        codes = []
        for d in self.donors:
            jids.append(d.jid)
            run_mem.append(d.perf.mem_bytes(d.sub_batch))
            t_run.append(d.solo_t_iter)
            rem_run.append(d.remaining_iters if rem_fn is None
                           else rem_fn(d))
            code = model_index.get(d.model)
            if code is None:
                code = model_index.setdefault(d.model, len(model_index))
            codes.append(code)
        self.jids = np.array(jids, dtype=np.int64)
        self.run_mem = np.array(run_mem, dtype=np.float64)
        self.t_run = np.array(t_run, dtype=np.float64)
        self.rem_run = np.array(rem_run, dtype=np.float64)
        self._models = list(model_index)      # code -> model name
        self._codes = np.array(codes, dtype=np.intp)
        self._xi_cache: dict = {}

    def __len__(self) -> int:
        return len(self.donors)

    def refresh_progress(self, rem_fn=None) -> None:
        """Re-read the donors' remaining iterations (the only per-pass
        mutable column — membership, memory, and iteration times only
        change with placements, which invalidate the whole batch).
        ``rem_fn`` reads a donor's remaining work virtually (e.g.
        ``Simulator.remaining_at``); default is the materialized
        ``remaining_iters``."""
        rem = self.rem_run
        if rem_fn is None:
            for i, d in enumerate(self.donors):
                rem[i] = d.remaining_iters
        else:
            for i, d in enumerate(self.donors):
                rem[i] = rem_fn(d)

    def xi_terms(self, new_model: str, interference: InterferenceModel):
        """Per-donor interference constants against ``new_model``:
        ``(fixed_mask, xi_run_fixed, xi_new_fixed, hit_run, hit_new)``.
        ``fixed_mask`` marks donors whose xi is sub-batch independent
        (global override or two-way pair-table hit — the scalar sweep
        breaks after the first feasible candidate for those);
        ``hit_run``/``hit_new`` carry one-way table hits (NaN where the
        structural model applies). xi depends only on the *model* pair,
        so the lookups run once per distinct donor model and fan out to
        donors through the model-code gather."""
        cached = self._xi_cache.get(new_model)
        if cached is not None:
            return cached
        k = len(self._models)
        fixed_u = np.zeros(k, dtype=bool)
        xi_run_u = np.ones(k, dtype=np.float64)
        xi_new_u = np.ones(k, dtype=np.float64)
        hit_run_u = np.full(k, np.nan, dtype=np.float64)
        hit_new_u = np.full(k, np.nan, dtype=np.float64)
        table = interference.table
        for code, model in enumerate(self._models):
            fixed = interference.pair_fixed(model, new_model)
            if fixed is not None:
                fixed_u[code] = True
                xi_run_u[code], xi_new_u[code] = fixed
                continue
            hr = table.get((model, new_model))
            if hr is not None:
                hit_run_u[code] = hr[0]
            hn = table.get((new_model, model))
            if hn is not None:
                hit_new_u[code] = hn[0]
        codes = self._codes
        cached = (fixed_u[codes], xi_run_u[codes], xi_new_u[codes],
                  hit_run_u[codes], hit_new_u[codes])
        self._xi_cache[new_model] = cached
        return cached


@dataclass
class DonorDecisions:
    """Per-donor Algorithm-2 outcomes for one pending job, as arrays.
    Row ``i`` corresponds to ``donors[i]``; rows with ``feasible[i]``
    False had no memory-feasible sub-batch (the scalar path's
    cannot-share sentinel). The Theorem-1 endpoint timelines are kept
    raw (``t_*0`` kappa=0, ``t_*1`` sequential); :meth:`config`
    materializes the chosen endpoint lazily — the scheduler hot path
    only reads ``share``/``avg_jct``/``sub_batch``."""

    donors: List[Job]
    new_batch: int
    feasible: np.ndarray     # bool[D] — any candidate fits beside donor
    share: np.ndarray        # bool[D] — Theorem-1 SF flag
    sub_batch: np.ndarray    # int[D]
    accum_steps: np.ndarray  # int[D]
    avg_jct: np.ndarray      # float[D] — pair-average JCT t_bar
    t_a0: np.ndarray         # float[D] — kappa=0 endpoint timelines
    t_b0: np.ndarray
    t_a1: np.ndarray         # float[D] — sequential endpoint timelines
    t_b1: np.ndarray
    xi_run: np.ndarray       # float[D]
    xi_new: np.ndarray       # float[D]

    def config(self, i: int) -> SharingConfig:
        """Materialize row ``i`` as the scalar API's SharingConfig."""
        if not self.feasible[i]:
            return SharingConfig(False, self.new_batch, 1, float("inf"), None)
        share = bool(self.share[i])
        avg = float(self.avg_jct[i])
        if share:
            dec = PairDecision(True, 0.0, float(self.t_a0[i]),
                               float(self.t_b0[i]), avg)
        else:
            dec = PairDecision(False, float(self.t_a1[i]),
                               float(self.t_a1[i]), float(self.t_b1[i]), avg)
        return SharingConfig(
            share=share, sub_batch=int(self.sub_batch[i]),
            accum_steps=int(self.accum_steps[i]), avg_jct=avg, decision=dec,
            xi_new=float(self.xi_new[i]), xi_run=float(self.xi_run[i]))


# ---------------------------------------------------------------------- #
def _theorem1(t_run, rem_run, xi_run, t_new, iters_new, xi_new):
    """Both Theorem-1 endpoints as array ops; mirrors
    ``pair.pair_timeline(a, b, 0)`` / ``pair.best_pair_schedule``
    expression-for-expression. Returns ``(share, avg, t_a0, t_b0, t_a1,
    t_b1)`` — the raw endpoint timelines, with ``share``/``avg`` already
    resolved per lane."""
    solo_a = t_run * rem_run
    solo_b = t_new * iters_new
    ta_sh = t_run * xi_run
    tb_sh = t_new * xi_new
    fin_a = rem_run * ta_sh
    fin_b = iters_new * tb_sh
    with np.errstate(divide="ignore", invalid="ignore"):
        # A finishes first: B continues solo with its remaining work.
        t_b_afirst = fin_a + (iters_new - fin_a / tb_sh) * t_new
        # B finishes first: A continues solo.
        t_a_bfirst = fin_b + (rem_run - fin_b / ta_sh) * t_run
    a_first = fin_a <= fin_b
    t_a0 = np.where(a_first, fin_a, t_a_bfirst)
    t_b0 = np.where(a_first, t_b_afirst, fin_b)
    # sequential endpoint, closed form
    t_a1 = solo_a
    t_b1 = solo_a + solo_b
    # kappa=0 >= solo_a (running job already out of work) degenerates to
    # the sequential timeline — same guard as the scalar pair_timeline.
    degen = solo_a <= 0.0
    if degen.any():
        t_a0 = np.where(degen, solo_a, t_a0)
        t_b0 = np.where(degen, t_b1, t_b0)
    avg0 = 0.5 * (t_a0 + t_b0)
    avg1 = 0.5 * (t_a1 + t_b1)
    share = avg0 <= avg1
    avg = np.where(share, avg0, avg1)
    return share, avg, t_a0, t_b0, t_a1, t_b1


def _structural_xi(interference, t_me, t_other, mem_frac):
    """Vectorized mirror of :func:`core.interference.structural_xi`
    at the scheduler's parameterization (contention coefficient, ratio
    capped at 4) — kept as array ops so the donor grid stays NumPy;
    the scalar function is the semantic source of truth."""
    ratio = t_other / np.maximum(t_me, 1e-12)
    xi = 1.0 + interference.contention * np.minimum(ratio, 4.0)
    return np.where(mem_frac > 0.8,
                    xi + interference.hbm_pressure * (mem_frac - 0.8) / 0.2,
                    xi)


def best_sharing_configs(
    new: Job,
    donors: "DonorBatch | Sequence[Job]",
    interference: InterferenceModel,
    gpu_capacity_bytes: float,
) -> DonorDecisions:
    """Batched Algorithm 2: the best sharing configuration of ``new``
    against every donor in one shot. Reproduces
    :func:`core.batch_scaling.best_sharing_config` bit-for-bit per
    donor (including the first-feasible shortcut the scalar sweep takes
    when xi is sub-batch independent)."""
    if not isinstance(donors, DonorBatch):
        donors = DonorBatch(donors)
    bs, ss, t_new_tab, mem_tab = job_candidate_table(new)
    d = len(donors)
    if d == 0:
        empty_f = np.zeros(0, dtype=np.float64)
        empty_b = np.zeros(0, dtype=bool)
        empty_i = np.zeros(0, dtype=np.int64)
        return DonorDecisions(donors.donors, new.batch, empty_b, empty_b,
                              empty_i, empty_i, empty_f, empty_f, empty_f,
                              empty_f, empty_f, empty_f.copy(),
                              empty_f.copy())

    run_mem = donors.run_mem
    t_run = donors.t_run
    rem_run = donors.rem_run
    iters_new = new.iters
    feasible = (mem_tab[None, :] + run_mem[:, None]) <= gpu_capacity_bytes
    any_feasible = feasible.any(axis=1)
    first_idx = np.argmax(feasible, axis=1)

    (fixed_mask, xi_run_fixed, xi_new_fixed,
     hit_run, hit_new) = donors.xi_terms(new.model, interference)

    if fixed_mask.all():
        # Every donor's xi is sub-batch independent: the scalar sweep
        # stops at the first feasible (largest) sub-batch, so only that
        # lane needs evaluating — O(D) instead of O(D x candidates).
        sel = first_idx
        xi_run_sel = xi_run_fixed
        xi_new_sel = xi_new_fixed
        share, avg, t_a0, t_b0, t_a1, t_b1 = _theorem1(
            t_run, rem_run, xi_run_sel, t_new_tab[sel], iters_new,
            xi_new_sel)
    else:
        # (donor x candidate) grid: structural xi depends on the
        # candidate's iteration time and the pair's memory pressure.
        t_new_g = t_new_tab[None, :]
        mem_frac = (run_mem[:, None] + mem_tab[None, :]) / gpu_capacity_bytes
        xi_run_g = _structural_xi(interference, t_run[:, None], t_new_g,
                                  mem_frac)
        xi_new_g = _structural_xi(interference, t_new_g, t_run[:, None],
                                  mem_frac)
        run_const = fixed_mask | ~np.isnan(hit_run)
        new_const = fixed_mask | ~np.isnan(hit_new)
        run_val = np.where(fixed_mask, xi_run_fixed, hit_run)
        new_val = np.where(fixed_mask, xi_new_fixed, hit_new)
        xi_run_g = np.where(run_const[:, None], run_val[:, None], xi_run_g)
        xi_new_g = np.where(new_const[:, None], new_val[:, None], xi_new_g)
        share_g, avg_g, t_a0_g, t_b0_g, _, _ = _theorem1(
            t_run[:, None], rem_run[:, None], xi_run_g, t_new_g,
            iters_new, xi_new_g)
        avg_masked = np.where(feasible, avg_g, np.inf)
        # first-occurrence argmin == the scalar sweep's strict-< update
        # (largest feasible sub-batch wins ties); fixed-xi donors keep
        # the scalar path's first-feasible break.
        sel = np.where(fixed_mask, first_idx, np.argmin(avg_masked, axis=1))
        rows = np.arange(d)
        share = share_g[rows, sel]
        avg = avg_g[rows, sel]
        t_a0 = t_a0_g[rows, sel]
        t_b0 = t_b0_g[rows, sel]
        t_a1 = t_run * rem_run          # candidate-independent endpoints
        t_b1 = t_a1 + t_new_tab[sel] * iters_new
        xi_run_sel = xi_run_g[rows, sel]
        xi_new_sel = xi_new_g[rows, sel]

    # quench rows with no feasible candidate to the scalar sentinel
    share = share & any_feasible
    avg = np.where(any_feasible, avg, np.inf)
    return DonorDecisions(
        donors=donors.donors, new_batch=new.batch, feasible=any_feasible,
        share=share, sub_batch=bs[sel], accum_steps=ss[sel], avg_jct=avg,
        t_a0=t_a0, t_b0=t_b0, t_a1=t_a1, t_b1=t_b1,
        xi_run=xi_run_sel, xi_new=xi_new_sel)


def best_sharing_config_batched(
    running: Job,
    new: Job,
    interference: InterferenceModel,
    gpu_capacity_bytes: float,
) -> SharingConfig:
    """Single-donor convenience wrapper with the scalar API's signature
    and return type (used by the equivalence tests)."""
    res = best_sharing_configs(new, [running], interference,
                               gpu_capacity_bytes)
    return res.config(0)
