"""Performance model of the paper (Eqs. 3, 4, 7, 14), the port's copy of
the reference's ``core/perf_model.py`` with the same arithmetic:

t_comp(B)    = alpha_comp + beta_comp * B                      (Eq. 3)
t_comm       = alpha_comm + beta_comm * M                      (Eq. 4)
t_iter(B, s) = (s-1) * t_comp(B/s)
               + (t_comp(B/s)**delta + t_comm**delta)**(1/delta)   (Eq. 7)
throughput   = B / t_iter                                      (Eq. 14)

All times are seconds, batch sizes are per-GPU samples, message sizes are
bytes. ``delta`` is the compute/communication overlap degree from Pollux
(delta=1: perfect serialization, larger delta -> more overlap).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class HardwareSpec:
    """Per-device hardware constants. No defaults: each spec names its
    own device."""

    peak_flops: float               # FLOP/s per device
    hbm_bytes_per_s: float          # memory bandwidth
    link_bytes_per_s: float         # per-link interconnect bandwidth
    mem_capacity: float             # device memory in bytes
    alpha_comm: float               # per-collective latency (s)
    mfu: float                      # assumed achievable model-flops util


# the paper's testbed
GPU_2080TI = HardwareSpec(
    peak_flops=13.4e12,            # fp32-ish effective training rate
    hbm_bytes_per_s=616e9,
    link_bytes_per_s=1.25e9,       # 10 Gbps node NIC
    mem_capacity=11 * 2**30,
    alpha_comm=50e-6,
    mfu=0.33,
)


@dataclass(frozen=True)
class PerfParams:
    """Fitted / derived coefficients of Eqs. 3-4-7 for one (job, #GPU) setting.

    ``mem_base``/``mem_per_sample`` form the paper's memory-feasibility
    constraint mem(b) = mem_base + mem_per_sample*b <= capacity, which is
    what gradient accumulation relaxes.
    """

    alpha_comp: float
    beta_comp: float
    alpha_comm: float
    beta_comm: float
    msg_bytes: float              # gradient message size M
    delta: float = 2.0
    mem_base: float = 0.0         # bytes: params + optimizer + framework
    mem_per_sample: float = 0.0   # bytes per sample of activation footprint
    param_bytes: float = 0.0      # raw gradient size (for elastic rescaling)
    n_workers: int = 1            # worker count these params were derived at

    def t_comp(self, batch: float) -> float:
        return self.alpha_comp + self.beta_comp * batch

    def t_comm(self) -> float:
        return self.alpha_comm + self.beta_comm * self.msg_bytes

    def t_iter(self, batch: float, accum_steps: int = 1) -> float:
        """Eq. 7: iteration time with ``accum_steps`` gradient-accumulation
        sub-steps at sub-batch ``batch/accum_steps``."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        sub = batch / accum_steps
        tc = self.t_comp(sub)
        tn = self.t_comm()
        overlap_tail = (tc ** self.delta + tn ** self.delta) ** (1.0 / self.delta)
        return (accum_steps - 1) * tc + overlap_tail

    def t_iter_sub(self, batch: float, sub_batch: float) -> float:
        """Eq. 7 at an explicit per-GPU sub-batch ``sub_batch``. When
        ``sub_batch`` does not divide ``batch`` the final micro-batch
        absorbs the remainder (``batch - (s-1)*sub_batch`` samples), so
        the effective batch is the same for every candidate. For
        divisors this equals ``t_iter(batch, batch // sub_batch)``."""
        if sub_batch <= 0:
            raise ValueError(f"sub_batch must be positive, got {sub_batch}")
        s = max(1, math.ceil(batch / sub_batch))
        last = batch - (s - 1) * sub_batch
        tc = self.t_comp(sub_batch)
        tn = self.t_comm()
        tail = (self.t_comp(last) ** self.delta
                + tn ** self.delta) ** (1.0 / self.delta)
        return (s - 1) * tc + tail

    def throughput(self, batch: float, accum_steps: int = 1) -> float:
        return batch / self.t_iter(batch, accum_steps)

    def mem_bytes(self, sub_batch: float) -> float:
        return self.mem_base + self.mem_per_sample * sub_batch

    def fits(self, sub_batch: float, capacity: float,
             other_mem: float = 0.0) -> bool:
        return self.mem_bytes(sub_batch) + other_mem <= capacity


def ring_allreduce_bytes(param_bytes: float, n_workers: int) -> float:
    """Per-worker bytes moved by a ring all-reduce of ``param_bytes``."""
    if n_workers <= 1:
        return 0.0
    return 2.0 * param_bytes * (n_workers - 1) / n_workers


def t_iter_at_workers(p: PerfParams, batch: float, accum_steps: int,
                      n_workers: int) -> float:
    """Eq. 7 re-evaluated at ``n_workers`` ring-all-reduce participants
    (latency term grows with log2(n), the bandwidth term with the ring
    payload), for an allocation other than the job's own G_k."""
    sub = batch / accum_steps
    tc = p.t_comp(sub)
    tn = (p.alpha_comm * max(1, math.ceil(math.log2(max(2, n_workers))))
          + p.beta_comm * ring_allreduce_bytes(p.param_bytes, n_workers))
    d = p.delta
    return (accum_steps - 1) * tc + (tc ** d + tn ** d) ** (1.0 / d)


def fit_comp_params(batches: Sequence[float],
                    times: Sequence[float]) -> tuple[float, float]:
    """Least-squares fit of Eq. 3: t = alpha + beta*B. Returns (alpha, beta)."""
    if len(batches) != len(times) or len(batches) < 2:
        raise ValueError("need >= 2 (batch, time) samples")
    n = len(batches)
    sx = sum(batches); sy = sum(times)
    sxx = sum(b * b for b in batches); sxy = sum(b * t for b, t in zip(batches, times))
    denom = n * sxx - sx * sx
    if denom == 0:
        raise ValueError("degenerate batch samples")
    beta = (n * sxy - sx * sy) / denom
    alpha = (sy - beta * sx) / n
    return alpha, beta


def infer_xi(t_iter_solo: float, t_iter_shared: float) -> float:
    """Interference ratio xi from solo vs shared iteration time (Eqs. 5-6)."""
    if t_iter_solo <= 0:
        raise ValueError("t_iter_solo must be positive")
    return t_iter_shared / t_iter_solo


def scaled(params: PerfParams, **overrides) -> PerfParams:
    return dataclasses.replace(params, **overrides)
