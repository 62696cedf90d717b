"""Workload generation following the Microsoft/Philly trace shape used by
the paper (Section VI-A), the port's copy of the reference's
``core/trace.py`` with the same random streams: GPU-demand and
iteration-count distributions, Poisson arrivals, a model mix over the six
Pollux tasks or any task table; datacenter-scale generators
(:func:`datacenter_trace`, :func:`philly_trace`) with heavy-tailed
demand for the Philly/Helios regime (thousands of jobs and GPUs); and
:func:`calibrated_trace` over profiles measured on a device. Every
generator defaults to the paper's card, ``GPU_2080TI``."""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .calibration import profiles_from_artifact
from .job import Job
from .perf_model import GPU_2080TI, HardwareSpec
from .tasks import PAPER_TASK_PROFILES, TaskProfile

__all__ = ["DATACENTER_GPU_DEMAND", "PHILLY_GPU_DEMAND", "TraceConfig",
           "calibrated_trace", "datacenter_trace", "generate_trace",
           "philly_trace", "physical_trace", "simulation_trace"]


@dataclass(frozen=True)
class TraceConfig:
    n_jobs: int = 240
    seed: int = 0
    mean_interarrival: float = 90.0          # Poisson arrivals (s)
    # Philly-like GPU demand distribution (paper: >4 GPUs == "large")
    gpu_demand: Sequence[tuple[int, float]] = (
        (1, 0.30), (2, 0.20), (4, 0.20), (8, 0.15), (12, 0.05), (16, 0.10))
    min_iters: int = 100
    max_iters: int = 5000
    log_uniform_iters: bool = True
    tasks: Optional[Dict[str, TaskProfile]] = None
    hw: HardwareSpec = GPU_2080TI
    task_weights: Optional[Dict[str, float]] = None


def _sample_iters(rng: random.Random, cfg: TraceConfig) -> int:
    if cfg.log_uniform_iters:
        lo, hi = math.log(cfg.min_iters), math.log(cfg.max_iters)
        return int(round(math.exp(rng.uniform(lo, hi))))
    return rng.randint(cfg.min_iters, cfg.max_iters)


def _sample_gpus(rng: random.Random, cfg: TraceConfig) -> int:
    r = rng.random()
    acc = 0.0
    for gpus, p in cfg.gpu_demand:
        acc += p
        if r <= acc:
            return gpus
    return cfg.gpu_demand[-1][0]


def generate_trace(cfg: TraceConfig) -> List[Job]:
    rng = random.Random(cfg.seed)
    tasks = cfg.tasks or PAPER_TASK_PROFILES
    names = sorted(tasks)
    weights = ([cfg.task_weights.get(n, 1.0) for n in names]
               if cfg.task_weights else None)
    jobs: List[Job] = []
    t = 0.0
    for jid in range(cfg.n_jobs):
        t += rng.expovariate(1.0 / cfg.mean_interarrival)
        name = rng.choices(names, weights=weights)[0]
        prof = tasks[name]
        gpus = _sample_gpus(rng, cfg)
        jobs.append(Job(
            jid=jid,
            model=name,
            arrival=t,
            gpus=gpus,
            iters=float(_sample_iters(rng, cfg)),
            batch=prof.default_batch,
            perf=prof.perf_params(gpus, cfg.hw),
        ))
    return jobs


def physical_trace(seed: int = 0) -> List[Job]:
    """The 30-job scaled-down trace of the physical 16-GPU experiment:
    20 jobs with <= 8 GPUs, 10 jobs with 12 or 16 GPUs, iterations in
    [100, 5000] (Section VI-A)."""
    rng = random.Random(seed)
    jobs: List[Job] = []
    t = 0.0
    specs = [rng.choice([1, 2, 4, 8]) for _ in range(20)] + \
            [rng.choice([12, 16]) for _ in range(10)]
    rng.shuffle(specs)
    names = sorted(PAPER_TASK_PROFILES)
    for jid, gpus in enumerate(specs):
        t += rng.expovariate(1.0 / 30.0)
        name = rng.choice(names)
        prof = PAPER_TASK_PROFILES[name]
        iters = int(round(math.exp(rng.uniform(math.log(100),
                                               math.log(5000)))))
        jobs.append(Job(
            jid=jid, model=name, arrival=t, gpus=gpus, iters=float(iters),
            batch=prof.default_batch,
            perf=prof.perf_params(gpus, GPU_2080TI),
        ))
    return jobs


# Heavy-tailed Philly/Helios-like demand mix: most jobs are small, a
# long tail of 32-128 GPU jobs carries a large share of the GPU-hours.
DATACENTER_GPU_DEMAND: Sequence[tuple[int, float]] = (
    (1, 0.32), (2, 0.22), (4, 0.17), (8, 0.12), (16, 0.08),
    (32, 0.05), (64, 0.03), (128, 0.01))


def datacenter_trace(
    n_jobs: int = 5000,
    seed: int = 0,
    n_gpus: int = 1024,
    utilization: float = 0.7,
    gpu_demand: Sequence[tuple[int, float]] = DATACENTER_GPU_DEMAND,
    min_iters: int = 200,
    max_iters: int = 50000,
    tasks: Optional[Dict[str, TaskProfile]] = None,
    hw: HardwareSpec = GPU_2080TI,
) -> List[Job]:
    """Datacenter-scale workload (configurable up to ~10k jobs / 4096
    GPUs): heavy-tailed GPU demand, log-uniform iteration counts, and
    Poisson arrivals whose rate is *derived from the target cluster
    utilization* — the offered load (solo GPU-seconds per wall-second)
    is ``utilization * n_gpus`` whatever the cluster size, so one knob
    sweeps clusters of 64 to 4096 GPUs. Fully determined by the
    arguments (same seed -> same trace)."""
    rng = random.Random(seed)
    tasks = tasks or PAPER_TASK_PROFILES
    names = sorted(tasks)
    lo, hi = math.log(min_iters), math.log(max_iters)
    specs = []
    total_gpu_seconds = 0.0
    for _ in range(n_jobs):
        name = rng.choice(names)
        prof = tasks[name]
        r = rng.random()
        acc = 0.0
        gpus = gpu_demand[-1][0]
        for g, p in gpu_demand:
            acc += p
            if r <= acc:
                gpus = g
                break
        gpus = min(gpus, n_gpus)
        iters = int(round(math.exp(rng.uniform(lo, hi))))
        perf = prof.perf_params(gpus, hw)
        est = perf.t_iter(prof.default_batch) * iters
        total_gpu_seconds += gpus * est
        specs.append((name, gpus, iters, perf, prof.default_batch))
    # arrival horizon that offers `utilization * n_gpus` GPU-seconds of
    # solo work per wall-second
    horizon = total_gpu_seconds / (n_gpus * max(utilization, 1e-9))
    mean_interarrival = horizon / n_jobs
    jobs: List[Job] = []
    t = 0.0
    for jid, (name, gpus, iters, perf, batch) in enumerate(specs):
        t += rng.expovariate(1.0 / mean_interarrival)
        jobs.append(Job(jid=jid, model=name, arrival=t, gpus=gpus,
                        iters=float(iters), batch=batch, perf=perf))
    return jobs


# Philly-shaped demand mix (Jeon et al., ATC'19 Fig. 2): the vast
# majority of jobs are 1-GPU, and the multi-GPU tail is thinner than the
# synthetic datacenter mix above — but it still carries most GPU-hours.
PHILLY_GPU_DEMAND: Sequence[tuple[int, float]] = (
    (1, 0.55), (2, 0.16), (4, 0.12), (8, 0.10), (16, 0.04),
    (32, 0.02), (64, 0.008), (128, 0.002))


def philly_trace(
    n_jobs: int = 5000,
    seed: int = 0,
    n_gpus: int = 1024,
    utilization: float = 0.7,
    gpu_demand: Sequence[tuple[int, float]] = PHILLY_GPU_DEMAND,
    median_seconds: float = 600.0,
    sigma: float = 1.8,
    min_seconds: float = 30.0,
    max_seconds: float = 30.0 * 86400.0,
    diurnal_amplitude: float = 0.5,
    tasks: Optional[Dict[str, TaskProfile]] = None,
    hw: HardwareSpec = GPU_2080TI,
) -> List[Job]:
    """Philly/Helios-shaped replay trace for capacity-planning sweeps
    (the reference's ``benchmarks/sim_scale.py`` ladder).

    Three distributional signatures of the production traces, all
    derived from the published trace analyses rather than raw replay:

    * **Job sizes** follow ``PHILLY_GPU_DEMAND`` — mostly 1-GPU jobs
      with a thin 32-128 GPU tail.
    * **Durations** are log-normal with a heavy tail
      (``median_seconds`` median, ``sigma`` log-std, clipped to
      ``[min_seconds, max_seconds]``); the iteration count is whatever
      delivers that *solo* duration on the sampled task's perf model,
      so the realized JCT distribution matches the target under
      no-sharing, no-queueing conditions.
    * **Arrivals** are a diurnal nonhomogeneous Poisson process,
      ``lam(t) = lam0 * (1 + amp * sin(2*pi*(t - 6h) / 24h))`` — peak
      at local noon, trough at midnight — realized by thinning against
      ``lam_max = lam0 * (1 + amp)``. The base rate ``lam0`` is derived
      from the target cluster ``utilization`` exactly like
      :func:`datacenter_trace`, so ``utilization=0.77`` answers "what
      does +10% load do to p95 queueing?" against a 0.7 baseline.

    Fully determined by the arguments (same seed -> same trace): specs
    are sampled first from a single sequential RNG stream, then the
    arrival process consumes the remainder of the stream.
    """
    rng = random.Random(seed)
    tasks = tasks or PAPER_TASK_PROFILES
    names = sorted(tasks)
    mu = math.log(median_seconds)
    specs = []
    total_gpu_seconds = 0.0
    for _ in range(n_jobs):
        name = rng.choice(names)
        prof = tasks[name]
        r = rng.random()
        acc = 0.0
        gpus = gpu_demand[-1][0]
        for g, p in gpu_demand:
            acc += p
            if r <= acc:
                gpus = g
                break
        gpus = min(gpus, n_gpus)
        dur = min(max_seconds, max(min_seconds, rng.lognormvariate(mu, sigma)))
        perf = prof.perf_params(gpus, hw)
        t_iter = perf.t_iter(prof.default_batch)
        iters = max(10, int(round(dur / t_iter)))
        total_gpu_seconds += gpus * iters * t_iter
        specs.append((name, gpus, iters, perf, prof.default_batch))
    # base rate offering `utilization * n_gpus` GPU-seconds of solo work
    # per wall-second, averaged over the diurnal cycle (the sine term
    # integrates to zero over whole days)
    horizon = total_gpu_seconds / (n_gpus * max(utilization, 1e-9))
    lam0 = n_jobs / max(horizon, 1e-9)
    amp = min(max(diurnal_amplitude, 0.0), 1.0)
    lam_max = lam0 * (1.0 + amp)
    day = 86400.0

    def rate(t: float) -> float:
        return lam0 * (1.0 + amp * math.sin(2.0 * math.pi * (t - 21600.0)
                                            / day))

    jobs: List[Job] = []
    t = 0.0
    for jid, (name, gpus, iters, perf, batch) in enumerate(specs):
        # thinning: candidate points at rate lam_max, accepted with
        # probability rate(t) / lam_max
        while True:
            t += rng.expovariate(lam_max)
            if rng.random() * lam_max <= rate(t):
                break
        jobs.append(Job(jid=jid, model=name, arrival=t, gpus=gpus,
                        iters=float(iters), batch=batch, perf=perf))
    return jobs


def calibrated_trace(payload, n_jobs: int = 30, seed: int = 0,
                     min_iters: int = 50, max_iters: int = 1000,
                     gpu_demand: Sequence[tuple[int, float]] = (
                         (1, 0.5), (2, 0.3), (4, 0.2)),
                     load: float = 4.0) -> List[Job]:
    """Workload over MEASURED profiles: job perf comes from a calibration
    artifact (``core.calibration``), so simulated seconds are the
    measuring device's seconds. Interarrival times scale with the
    measured mean iteration time — ``load`` is roughly how many solo
    jobs' worth of work arrives per mean job duration."""
    profiles = profiles_from_artifact(payload)
    names = sorted(profiles)
    rng = random.Random(seed)
    lo, hi = math.log(min_iters), math.log(max_iters)
    mean_iters = math.exp(0.5 * (lo + hi))
    mean_t_iter = sum(
        p.params.t_iter(p.default_batch) for p in profiles.values()
    ) / len(profiles)
    mean_interarrival = mean_iters * mean_t_iter / max(load, 1e-9)
    jobs: List[Job] = []
    t = 0.0
    for jid in range(n_jobs):
        t += rng.expovariate(1.0 / mean_interarrival)
        prof = profiles[rng.choice(names)]
        r = rng.random()
        acc = 0.0
        gpus = gpu_demand[-1][0]
        for g, p in gpu_demand:
            acc += p
            if r <= acc:
                gpus = g
                break
        iters = int(round(math.exp(rng.uniform(lo, hi))))
        jobs.append(Job(
            jid=jid, model=prof.name, arrival=t, gpus=gpus,
            iters=float(iters), batch=prof.default_batch,
            perf=prof.perf_params(gpus),
        ))
    return jobs


def simulation_trace(n_jobs: int = 240, seed: int = 0,
                     load_scale: float = 1.0,
                     tasks: Optional[Dict[str, TaskProfile]] = None,
                     hw: HardwareSpec = GPU_2080TI) -> List[Job]:
    """The 240/480-job simulation workloads (Tables III/IV); ``load_scale``
    compresses/stretches interarrival times for the Fig. 6a sweep."""
    cfg = TraceConfig(
        n_jobs=n_jobs,
        seed=seed,
        mean_interarrival=90.0 / max(load_scale, 1e-9),
        max_iters=20000,
        min_iters=200,
        tasks=tasks,
        hw=hw,
    )
    return generate_trace(cfg)
