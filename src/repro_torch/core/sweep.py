"""Parallel scenario sweeps — policy x load x seed grids fanned across
worker processes (the port's copy of the reference's ``core/sweep.py``).

A scenario is a frozen :class:`ScenarioSpec`; every worker rebuilds its
trace deterministically from the spec fields alone (nothing is shared
between processes), so a sweep's aggregate output is byte-identical
however it is partitioned across workers — including ``workers=1`` —
and, for the same specs, byte-identical to the reference's. Workers
import ``repro_torch`` only.
"""
from __future__ import annotations

import csv
import io
import json
import math
import multiprocessing
import os
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .interference import InterferenceModel, paper_interference_model
from .job import ClusterState
from .schedulers import ALL_POLICIES, make_scheduler
from .simulator import Simulator
from .trace import (datacenter_trace, philly_trace, physical_trace,
                    simulation_trace)

__all__ = [
    "ScenarioSpec", "grid", "normalize_policy", "run_scenario",
    "run_sweep", "rows_by_policy", "summary_table", "to_canonical_json",
    "write_csv", "write_json",
]

# row keys that vary between runs and are excluded from canonical output
_NONDETERMINISTIC = ("wall_seconds",)


def normalize_policy(name: str) -> str:
    """Accept ``sjf_bsbf`` and ``SJF-BSBF`` spellings for ``sjf-bsbf``."""
    name = name.strip().lower().replace("_", "-")
    if name not in ALL_POLICIES:
        raise ValueError(f"unknown policy {name!r}; "
                         f"choose from {sorted(ALL_POLICIES)}")
    return name


@dataclass(frozen=True)
class ScenarioSpec:
    """One simulation scenario, fully determined by its fields (the
    worker regenerates the trace from ``seed``/``n_jobs``/``load_scale``,
    so the same spec always produces the same row)."""

    policy: str
    n_jobs: int = 240
    seed: int = 0
    # trace="datacenter"/"philly" read load_scale as a multiplier on the
    # 0.7 target cluster utilization of the corresponding trace builder
    load_scale: float = 1.0
    # "simulation" | "physical" | "datacenter" | "philly"
    trace: str = "simulation"
    n_servers: int = 16
    gpus_per_server: int = 4
    capacity_gb: float = 11.0
    global_xi: Optional[float] = None  # Fig. 6b style xi injection
    # None lets the Simulator resolve (heap)
    engine: Optional[str] = None
    # sharing-decision path: None -> the Simulator's default (scalar);
    # "grid" or "batched" for the vectorized paths
    decision: Optional[str] = None
    collect: Tuple[str, ...] = ()      # extra per-job metrics (below)
    tag: str = ""                      # free-form grouping label


def grid(policies: Sequence[str], *, seeds: Sequence[int] = (0,),
         loads: Sequence[float] = (1.0,), **common) -> List[ScenarioSpec]:
    """The policy x seed x load cross product; remaining spec fields come
    from ``common``."""
    return [
        ScenarioSpec(policy=normalize_policy(p), seed=seed,
                     load_scale=load, **common)
        for load in loads for seed in seeds for p in policies
    ]


# ---------------------------------------------------------------------- #
# Per-job metric collectors (computed in the worker so only small rows
# cross the process boundary)
# ---------------------------------------------------------------------- #
def _percentile(sorted_vals: List[float], q: float) -> float:
    """numpy's default linear-interpolation percentile, dependency-free."""
    n = len(sorted_vals)
    if n == 1:
        return float(sorted_vals[0])
    rank = q / 100.0 * (n - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return float(sorted_vals[lo])
    return float(sorted_vals[lo]
                 + (sorted_vals[hi] - sorted_vals[lo]) * (rank - lo))


def _jct_deciles(res) -> List[float]:
    jcts = res.jct_list()
    return [_percentile(jcts, q) for q in range(10, 101, 10)]


def _queue_by_model(res) -> Dict[str, float]:
    acc: Dict[str, List[float]] = {}
    for j in res.jobs:
        acc.setdefault(j.model, []).append(j.queueing_delay())
    return {m: sum(v) / len(v) for m, v in sorted(acc.items())}


def _jct_list(res) -> List[float]:
    return res.jct_list()


def _queue_percentiles(res) -> Dict[str, float]:
    """p50/p90/p95/p99 queueing delay — the capacity-planning readout
    ("what does +10% load do to p95?")."""
    delays = sorted(j.queueing_delay() for j in res.jobs)
    if not delays:
        return {"p50": 0.0, "p90": 0.0, "p95": 0.0, "p99": 0.0}
    return {f"p{q}": _percentile(delays, q) for q in (50, 90, 95, 99)}


_COLLECTORS = {
    "jct_deciles": _jct_deciles,
    "queue_by_model": _queue_by_model,
    "jct_list": _jct_list,
    "queue_percentiles": _queue_percentiles,
}


# ---------------------------------------------------------------------- #
def _build_jobs(spec: ScenarioSpec):
    if spec.trace == "physical":
        if spec.load_scale != 1.0:
            raise ValueError(
                "the physical trace has a fixed 30-job arrival pattern; "
                "load_scale is only supported for trace='simulation'")
        return physical_trace(seed=spec.seed)
    if spec.trace == "simulation":
        return simulation_trace(n_jobs=spec.n_jobs, seed=spec.seed,
                                load_scale=spec.load_scale)
    if spec.trace == "datacenter":
        return datacenter_trace(
            n_jobs=spec.n_jobs, seed=spec.seed,
            n_gpus=spec.n_servers * spec.gpus_per_server,
            utilization=0.7 * spec.load_scale)
    if spec.trace == "philly":
        return philly_trace(
            n_jobs=spec.n_jobs, seed=spec.seed,
            n_gpus=spec.n_servers * spec.gpus_per_server,
            utilization=0.7 * spec.load_scale)
    raise ValueError(f"unknown trace kind {spec.trace!r}")


def run_scenario(spec: ScenarioSpec) -> Dict:
    """Run one scenario and reduce it to a plain-dict row (module-level so
    multiprocessing can pickle it)."""
    for metric in spec.collect:
        if metric not in _COLLECTORS:
            raise ValueError(f"unknown collect metric {metric!r}; "
                             f"choose from {sorted(_COLLECTORS)}")
    jobs = _build_jobs(spec)
    cluster = ClusterState(
        n_servers=spec.n_servers,
        gpus_per_server=spec.gpus_per_server,
        gpu_capacity_bytes=spec.capacity_gb * 2 ** 30)
    interference = (InterferenceModel(global_xi=spec.global_xi)
                    if spec.global_xi is not None
                    else paper_interference_model())
    sim = Simulator(cluster, jobs, make_scheduler(spec.policy),
                    interference=interference, engine=spec.engine,
                    decision=spec.decision)
    t0 = time.time()
    res = sim.run()
    row = dict(asdict(spec))
    row["n_jobs"] = len(jobs)   # physical traces fix their own job count
    row["engine"] = sim.engine_name   # record the resolved engine
    row["decision"] = sim.decision_path   # record the resolved path
    row["collect"] = list(spec.collect)
    row["events"] = res.events
    row["summary"] = res.summary()
    for metric in spec.collect:
        row[metric] = _COLLECTORS[metric](res)
    row["wall_seconds"] = time.time() - t0
    return row


def _export_import_path() -> None:
    """Make sure spawned workers can import ``repro_torch`` even when
    the parent got it from pytest's ``pythonpath`` hook or an ad-hoc
    ``sys.path`` edit rather than an install or the PYTHONPATH env."""
    src_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    existing = os.environ.get("PYTHONPATH", "")
    if src_root not in existing.split(os.pathsep):
        os.environ["PYTHONPATH"] = (
            src_root + (os.pathsep + existing if existing else ""))


def run_sweep(specs: Sequence[ScenarioSpec], workers: Optional[int] = None,
              ) -> List[Dict]:
    """Run every scenario, fanning across ``workers`` processes (default:
    one per scenario up to the CPU count). Rows come back in spec order
    regardless of which worker finished first.

    Workers are *spawned*, not forked: callers routinely have PyTorch
    (and its thread pools) imported, and forking a multithreaded parent
    can deadlock the child."""
    specs = list(specs)
    if workers is None:
        workers = min(len(specs), os.cpu_count() or 1)
    if workers <= 1 or len(specs) <= 1:
        return [run_scenario(s) for s in specs]
    _export_import_path()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=min(workers, len(specs))) as pool:
        return pool.map(run_scenario, specs, chunksize=1)


# ---------------------------------------------------------------------- #
# Aggregation / serialization
# ---------------------------------------------------------------------- #
def rows_by_policy(rows: Sequence[Dict]) -> Dict[str, Dict]:
    """{policy: summary} for single-seed single-load sweeps (the paper
    tables' payload shape)."""
    out: Dict[str, Dict] = {}
    for row in rows:
        out[row["policy"]] = row["summary"]
    return out


def to_canonical_json(rows: Sequence[Dict]) -> bytes:
    """Deterministic serialization: drops wall-clock fields, sorts keys.
    Two runs of the same sweep produce byte-identical output whatever
    the worker count."""
    canonical = [{k: v for k, v in row.items()
                  if k not in _NONDETERMINISTIC} for row in rows]
    return (json.dumps(canonical, sort_keys=True, indent=1) + "\n").encode()


def write_json(rows: Sequence[Dict], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(to_canonical_json(rows))
    return path


_CSV_FIELDS = ("tag", "trace", "policy", "n_jobs", "seed", "load_scale",
               "global_xi", "engine", "decision", "events")


def write_csv(rows: Sequence[Dict], path: str) -> str:
    """Flat CSV: spec fields + one column per summary metric."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    metric_keys: List[str] = []
    for row in rows:
        for k in row["summary"]:
            if k not in metric_keys:
                metric_keys.append(k)
    buf = io.StringIO()
    writer = csv.writer(buf, lineterminator="\n")
    writer.writerow(list(_CSV_FIELDS) + metric_keys)
    for row in rows:
        writer.writerow([row.get(f, "") for f in _CSV_FIELDS]
                        + [row["summary"].get(k, "") for k in metric_keys])
    with open(path, "w") as f:
        f.write(buf.getvalue())
    return path


def summary_table(rows: Sequence[Dict], title: str) -> str:
    """Paper-style fixed-width table over summary rows."""
    lines = [title,
             f"{'policy':<10} {'load':>5} {'seed':>4} {'makespan':>10} "
             f"{'avg JCT':>10} {'JCT lg':>9} {'JCT sm':>9} {'queue':>9} "
             f"{'q lg':>8} {'q sm':>8}"]
    for row in rows:
        s = row["summary"]
        lines.append(
            f"{row['policy']:<10} {row['load_scale']:>5.2f} "
            f"{row['seed']:>4d} {s['makespan']:>10.1f} "
            f"{s['avg_jct']:>10.1f} {s['avg_jct_large']:>9.1f} "
            f"{s['avg_jct_small']:>9.1f} {s['avg_queue']:>9.1f} "
            f"{s['avg_queue_large']:>8.1f} {s['avg_queue_small']:>8.1f}")
    return "\n".join(lines)
