"""The paper's experiment in one script (the twin of the reference's
``examples/cluster_scheduling.py``): schedule a multi-tenant DL job trace
with SJF-BSBF and compare it against FIFO/SJF/Tiresias/Pollux-like/
SJF-FFS on average JCT and queueing delay.

    python -m repro_torch.launch.cluster_scheduling [--jobs 120]
    python -m repro_torch.launch.cluster_scheduling --calibrated [PATH]

With ``--calibrated`` it runs instead the calibrated mode of the
reference's ``benchmarks/table2_physical.py``: the job profiles and the
xi table come from a calibration artifact (default
``artifacts/bench/calibration_cuda.json``, which
``launch.calibrate`` writes on the card), 30 jobs of
``calibrated_trace(load=6.0)`` on 2 x 2 GPUs whose capacity admits each
measured arch at full batch beside a half-batch co-tenant, all seven
policies, and the paper's two headline checks. It reads the artifact on
the host and needs no GPU.
"""
from __future__ import annotations

import argparse
import copy
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core import (ClusterState, InterferenceModel, Simulator,
                              calibrated_trace, load_artifact,
                              make_scheduler, paper_interference_model,
                              simulation_trace)
from repro_torch.launch.calibrate import CALIBRATION_PATH

# the example's six policies, and the seven of the paper's tables
POLICIES = ("fifo", "sjf", "tiresias", "pollux", "sjf-ffs", "sjf-bsbf")
ALL_SEVEN = ("fifo", "sjf", "srsf", "tiresias", "pollux", "sjf-ffs",
             "sjf-bsbf")


def calibrated_capacity(payload) -> float:
    """Capacity admitting every measured arch at full batch with head-
    room for one half-batch co-tenant (the reference's
    ``_calibrated_capacity``): the same C=2 sharing regime the paper's
    11 GB cards give its tasks."""
    needs = [e["mem_base"] + e["mem_per_sample"] * e["batch"]
             for e in payload["archs"].values()]
    halves = [e["mem_per_sample"] * max(1, e["batch"] // 2)
              + e["mem_base"] for e in payload["archs"].values()]
    return max(needs) + max(halves) + 0.25 * max(
        e["mem_per_sample"] for e in payload["archs"].values())


def run_policies(jobs, policies: Sequence[str], *, n_servers: int,
                 gpus_per_server: int, capacity_gb: float = 11.0,
                 interference: Optional[InterferenceModel] = None,
                 engine: Optional[str] = None,
                 decision: Optional[str] = None) -> Dict[str, dict]:
    """Each policy on its own deep copy of ``jobs``: ``{policy: {"res",
    "sim", "seconds"}}`` (``seconds`` of ``Simulator.run`` alone)."""
    out = {}
    for policy in policies:
        cluster = ClusterState(n_servers=n_servers,
                               gpus_per_server=gpus_per_server,
                               gpu_capacity_bytes=capacity_gb * 2 ** 30)
        kw = {"decision": decision} if policy == "sjf-bsbf" else {}
        sim = Simulator(cluster, copy.deepcopy(jobs),
                        make_scheduler(policy, **kw),
                        interference=interference
                        or paper_interference_model(), engine=engine)
        t0 = time.perf_counter()
        res = sim.run()
        out[policy] = {"res": res, "sim": sim,
                       "seconds": time.perf_counter() - t0}
    return out


def calibrated_run(payload, seed: int = 0,
                   policies: Sequence[str] = ALL_SEVEN,
                   decision: Optional[str] = None) -> Dict[str, dict]:
    """The calibrated mode of ``table2_physical``: 30 jobs of
    ``calibrated_trace(load=6.0)`` on 2 x 2 GPUs, xi from the artifact."""
    jobs = calibrated_trace(payload, n_jobs=30, seed=seed, load=6.0)
    return run_policies(
        jobs, policies, n_servers=2, gpus_per_server=2,
        capacity_gb=calibrated_capacity(payload) / 2 ** 30,
        interference=InterferenceModel.from_artifact(payload),
        decision=decision)


def headline(results: Dict[str, dict]) -> Dict[str, bool]:
    """The paper's two headline checks on a run of every policy."""
    s = {p: r["res"].summary() for p, r in results.items()}
    return {
        "sharing_beats_exclusive":
            s["sjf-bsbf"]["avg_jct"] < s["sjf"]["avg_jct"],
        "bsbf_within_ffs_plus_5pct":
            s["sjf-bsbf"]["avg_jct"] <= s["sjf-ffs"]["avg_jct"] * 1.05,
    }


def print_table(results: Dict[str, dict], base: str = "fifo") -> None:
    print(f"{'policy':<10} {'avg JCT':>10} {'avg queue':>10} "
          f"{'makespan':>10} {'preempt':>8}")
    ref = results[base]["res"].summary()["avg_jct"]
    for policy, r in results.items():
        s = r["res"].summary()
        n_preempt = sum(j.preemptions for j in r["res"].jobs)
        print(f"{policy:<10} {s['avg_jct']:>10.1f} {s['avg_queue']:>10.1f} "
              f"{s['makespan']:>10.1f} {n_preempt:>8d}"
              f"   ({(1 - s['avg_jct'] / ref) * 100:+.1f}% vs FIFO)")


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--jobs", type=int, default=120)
    ap.add_argument("--servers", type=int, default=16)
    ap.add_argument("--gpus-per-server", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibrated", nargs="?", const=CALIBRATION_PATH,
                    default=None, metavar="PATH",
                    help="run the trace over the profiles of a "
                         "calibration artifact (default: "
                         f"{CALIBRATION_PATH})")
    args = ap.parse_args(argv)

    if args.calibrated:
        payload = load_artifact(args.calibrated)
        print(f"30 jobs on 2x2 GPUs, profiles and xi from "
              f"{args.calibrated} ({payload.get('host', {}).get('kind')})")
        results = calibrated_run(payload, seed=args.seed)
        print_table(results)
        checks = headline(results)
        print(f"  sharing beats exclusive: "
              f"{checks['sharing_beats_exclusive']}; BSBF <= FFS(+5%): "
              f"{checks['bsbf_within_ffs_plus_5pct']}")
        return results
    print(f"{args.jobs} jobs on {args.servers}x{args.gpus_per_server} GPUs")
    jobs = simulation_trace(n_jobs=args.jobs, seed=args.seed)
    results = run_policies(jobs, POLICIES, n_servers=args.servers,
                           gpus_per_server=args.gpus_per_server)
    print_table(results)
    return results


if __name__ == "__main__":
    main()
