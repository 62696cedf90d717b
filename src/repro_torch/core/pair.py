"""Theorem 1 — optimal scheduling of one running job A + one new job B on
the same GPU set.

Timeline (kappa = launch time of the new job B, measured from "now"):
  [0, kappa):            A runs solo at iteration time t_A
  [kappa, first_finish): A and B run concurrently at t_A*xi_A / t_B*xi_B
  afterwards:            the survivor runs solo again

Theorem 1 states the pair-average JCT is minimized at one of the two
extremes: kappa = 0 (launch immediately) or kappa = t_A * i_A (fully
sequential). We implement the exact timeline evaluator and pick the best
endpoint; ``tests/test_theorem1.py`` property-checks the endpoint claim
against a brute-force kappa grid. The port's copy of the reference's
``core/pair.py``, same arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PairJob:
    """One side of a sharing pair: solo iteration time, remaining
    iterations, and interference ratio while sharing."""

    t_iter: float   # solo iteration time (s)
    iters: float    # remaining iterations
    xi: float       # interference ratio while co-running (>= 1)

    @property
    def solo_time(self) -> float:
        return self.t_iter * self.iters

    @property
    def shared_t_iter(self) -> float:
        return self.t_iter * self.xi


@dataclass(frozen=True)
class PairDecision:
    share: bool          # SF flag: True -> launch B now (kappa = 0)
    kappa: float         # chosen insertion time
    jct_a: float         # completion time of the running job (from now)
    jct_b: float         # completion time of the new job (from now)
    avg_jct: float

    @property
    def makespan(self) -> float:
        return max(self.jct_a, self.jct_b)


def pair_timeline(a: PairJob, b: PairJob, kappa: float) -> tuple[float, float]:
    """Exact (T_A, T_B) for launching B at time ``kappa``; B's JCT is
    measured from now (its queueing time ``kappa`` is included)."""
    if kappa < 0:
        raise ValueError("kappa must be >= 0")
    t_a_solo_total = a.solo_time
    if kappa >= t_a_solo_total:
        # Fully sequential: A finishes untouched, then B runs solo.
        t_a = t_a_solo_total
        start_b = max(kappa, t_a)
        return t_a, start_b + b.solo_time

    # Phase 1: A solo during [0, kappa).
    iters_a_done = kappa / a.t_iter
    rem_a = a.iters - iters_a_done
    # Phase 2: concurrent from kappa.
    ta_shared = a.shared_t_iter
    tb_shared = b.shared_t_iter
    fin_a_shared = rem_a * ta_shared       # time A needs if sharing persists
    fin_b_shared = b.iters * tb_shared     # time B needs if sharing persists
    if fin_a_shared <= fin_b_shared:
        # A finishes first; B then continues solo.
        t_a = kappa + fin_a_shared
        iters_b_done = fin_a_shared / tb_shared
        t_b = t_a + (b.iters - iters_b_done) * b.t_iter
    else:
        # B finishes first; A then continues solo.
        t_b = kappa + fin_b_shared
        iters_a_done2 = fin_b_shared / ta_shared
        t_a = t_b + (rem_a - iters_a_done2) * a.t_iter
    return t_a, t_b


def best_pair_schedule(a: PairJob, b: PairJob) -> PairDecision:
    """Theorem 1: compare kappa=0 (full overlap) vs kappa=t_A*i_A
    (sequential) and return the better average-JCT decision."""
    t_a0, t_b0 = pair_timeline(a, b, 0.0)
    seq_kappa = a.solo_time
    # sequential endpoint, closed form: A untouched, B queued behind it
    # (identical to pair_timeline(a, b, seq_kappa), without the call)
    t_a1 = seq_kappa
    t_b1 = seq_kappa + b.solo_time
    avg0 = 0.5 * (t_a0 + t_b0)
    avg1 = 0.5 * (t_a1 + t_b1)
    if avg0 <= avg1:
        return PairDecision(True, 0.0, t_a0, t_b0, avg0)
    return PairDecision(False, seq_kappa, t_a1, t_b1, avg1)


def monotonicity_coefficient(a: PairJob, b: PairJob) -> float:
    """The paper's sign term 2*xi_B + xi_A - 2*xi_A*xi_B (Eq. 24): positive
    -> avg JCT increases with kappa (share now), negative -> sequential."""
    return 2.0 * b.xi + a.xi - 2.0 * a.xi * b.xi
