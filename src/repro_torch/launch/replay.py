"""Replay/validation of a simulated schedule (the twin of the reference's
``benchmarks/replay_validation.py``, with its scenario and its output
fields): simulate a 4-job SJF-BSBF schedule whose performance model is
entirely device-measured (a calibration artifact: fitted Eq.-3
alpha/beta and measured pairwise xi), then execute that schedule on the
device through the schedule executor and report per-job predicted vs
measured execution time.

The scenario exercises the full event model: job A holds both GPUs of a
1-server/2-GPU cluster; B and C are admitted onto A's GPUs (a 3-way
shared group), with the memory capacity sized so that B's admission
needs the donor-rescaling extension, a mid-run (τ, sub-batch)
reconfiguration of A at the sharing time point; when A's last sharer
departs, ``reconfig_on_release`` restores A's full sub-batch (a second
reconfiguration). D arrives while both GPUs are doubly tenanted and
queues. Replay also checks that sharing changes no job's training: each
job's final parameters must equal, bitwise, those of a solo re-run
through the same start sub-batch and the same reconfigurations at the
same step indices.

    python -m repro_torch.launch.replay                        # the card
    python -m repro_torch.launch.replay --reduced --device cpu

At full width the jobs keep half their layers unless ``--depth-fraction``
says otherwise: A + C + D start together, and at full depth their states
alone (bf16 params, f32 moments) take 69.9 GB of an 80 GB card before
one step's transients. ``--reduced`` keeps every layer.

Without ``--artifact`` it measures its own scenario-sized calibration
(every pair) first; ``--artifact PATH`` replays against a saved one
(``artifacts/bench/calibration_cuda.json``, from
``python -m repro_torch.launch.calibrate``). Writes
``artifacts/bench/replay_validation_cuda.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Tuple

import torch

from repro_torch.core.calibration import (load_artifact,
                                          profiles_from_artifact,
                                          run_calibration)
from repro_torch.core.interference import InterferenceModel
from repro_torch.core.job import ClusterState, Job
from repro_torch.core.perf_model import scaled
from repro_torch.core.schedulers import SJF_BSBF
from repro_torch.core.simulator import Simulator
from repro_torch.launch.calibrate import (ARTIFACTS, CALIBRATION_PATH,
                                          build_specs, peak_memory)
from repro_torch.launch.cluster import (JobSpec, SchedulePlan,
                                        ScheduleExecutor, _components,
                                        plan_from_sim)
from repro_torch.tree import flatten

ARCH_A = "minicpm-2b"     # donor arch (jobs A and D)
ARCH_B = "qwen2-vl-2b"    # sharer arch (jobs B and C)
NAMES = {0: "A", 1: "B", 2: "C", 3: "D"}
REPLAY_PATH = os.path.join(ARTIFACTS, "replay_validation_cuda.json")

MEM_BASE = 4.0 * 2 ** 30          # scenario memory geometry: the TIMING
MEM_PER_SAMPLE = 0.25 * 2 ** 30   # side is measured (alpha/beta, xi);
                                  # memory is sized so the schedule must
                                  # exercise the (τ, sub-batch) machinery


def build_scenario(payload, iters_a: int = 16):
    """4 jobs + a capacity forcing the (τ, sub-batch) structure. The
    iteration-time coefficients and xi come from the calibration
    artifact; the memory footprint uses the uniform scenario geometry
    above: capacity admits donor@B/2 + sharer@B/2 but not
    donor@B + sharer@1, so B's admission requires the donor-rescaling
    reconfiguration and every sharer runs gradient-accumulated."""
    profs = profiles_from_artifact(payload)
    geom = dict(mem_base=MEM_BASE, mem_per_sample=MEM_PER_SAMPLE)
    pa = scaled(profs[ARCH_A].params, **geom)
    pb = scaled(profs[ARCH_B].params, **geom)
    batch_a = profs[ARCH_A].default_batch
    batch_b = profs[ARCH_B].default_batch
    half_a, half_b = max(1, batch_a // 2), max(1, batch_b // 2)
    slack = 0.25 * MEM_PER_SAMPLE
    cap = pa.mem_bytes(half_a) + max(pb.mem_bytes(half_b),
                                     pa.mem_bytes(half_a)) + slack
    if not pa.mem_bytes(batch_a) <= cap:
        raise ValueError("A must fit alone at full batch")
    if not pa.mem_bytes(batch_a) + pb.mem_bytes(1) > cap:
        raise ValueError("sharer must not fit beside an unreconfigured donor")
    t_a = pa.t_iter(batch_a)
    # Theorem 1 with measured xi ~= 2-2.5 only admits a sharer whose
    # remaining work is a small fraction of the donor's (and the
    # donor-rescaling variant additionally charges the donor's slowdown),
    # so the donor runs long and the sharers are short.
    jobs = [
        Job(jid=0, model=ARCH_A, arrival=0.0, gpus=2,
            iters=float(iters_a), batch=batch_a, perf=pa),
        Job(jid=1, model=ARCH_B, arrival=2.0 * t_a, gpus=1,
            iters=float(max(2, iters_a // 12)), batch=batch_b, perf=pb),
        Job(jid=2, model=ARCH_B, arrival=4.0 * t_a, gpus=1,
            iters=float(max(3, iters_a // 8)), batch=batch_b, perf=pb),
        Job(jid=3, model=ARCH_A, arrival=6.0 * t_a, gpus=1,
            iters=float(max(2, iters_a // 12)), batch=batch_a, perf=pa),
    ]
    return jobs, cap


def _structure(log):
    """Schedule-shape facts: the largest sharing component and the
    mid-run reconfiguration events. Components only grow when a job
    starts, so the largest is read at each start."""
    placements = {}
    max_component = 0
    reconfigs = []
    for entry in log:
        kind = entry[1]
        if kind == "start":
            placements[entry[2]] = frozenset(entry[3])
            max_component = max(max_component, *map(
                len, _components(placements)))
        elif kind == "finish":
            placements.pop(entry[2], None)
        elif kind == "reconfig":
            reconfigs.append({"t": entry[0], "jid": entry[2],
                              "sub_batch": entry[3],
                              "accum_steps": entry[4]})
    return max_component, reconfigs


def simulate(payload, iters_a: int = 24):
    """The scenario through the port's simulator: (sim, results, plan)."""
    jobs, cap = build_scenario(payload, iters_a=iters_a)
    cluster = ClusterState(n_servers=1, gpus_per_server=2,
                           gpu_capacity_bytes=cap)
    interference = InterferenceModel.from_artifact(payload)
    sim = Simulator(cluster, jobs, SJF_BSBF(donor_reconfig=True),
                    interference=interference, reconfig_on_release=True)
    res = sim.run()
    plan = plan_from_sim(sim.log, sim.jobs, interference, cap, names=NAMES)
    return sim, res, plan


def job_specs(sim, specs: Dict[str, JobSpec]) -> Dict[str, Tuple[JobSpec, int]]:
    """Executor name -> (spec, steps): each simulated job trains its
    arch's spec with seed ``10 + jid`` for ``job.iters`` steps."""
    out = {}
    for jid, job in sim.jobs.items():
        arch = ARCH_A if job.model == ARCH_A else ARCH_B
        out[NAMES[jid]] = (dataclasses.replace(specs[arch], seed=10 + jid),
                           int(job.iters))
    return out


def _host_params(params) -> Dict[str, torch.Tensor]:
    return {k: t.detach().cpu() for k, t in flatten(params).items()}


class _KeepFinal(ScheduleExecutor):
    """Keeps each finished job's final parameters, on the host, before
    :meth:`finish` releases its device state."""

    def __init__(self, **kw) -> None:
        super().__init__(**kw)
        self.final: Dict[str, Dict[str, torch.Tensor]] = {}

    def finish(self, name: str):
        self.final[name] = _host_params(self.runs[name].params)
        return super().finish(name)


def execute(plan: SchedulePlan, jobs: Dict[str, Tuple[JobSpec, int]],
            device=None):
    """Run ``plan``; returns (executor, report). ``executor.final`` holds
    each job's final parameters on the host."""
    ex = _KeepFinal(device=device)
    for name, (spec, steps) in jobs.items():
        ex.submit(name, spec, steps)
    return ex, ex.execute(plan)


def start_sub_batches(plan: SchedulePlan) -> Dict[str, int]:
    return {op.job: op.sub_batch for phase in plan.phases
            for op in phase.ops if op.kind == "start"}


def step_sub_batches(start_sub: int, reconfigs: List[Tuple[int, int]],
                     steps: int) -> List[int]:
    """The sub-batch of each of ``steps`` steps: ``start_sub``, changed to
    b before step k for each (k, b) of ``reconfigs`` (an executor's
    ``runs[name].reconfigs``)."""
    subs, sub, todo = [], start_sub, list(reconfigs)
    for step in range(steps):
        while todo and todo[0][0] == step:
            sub = todo.pop(0)[1]
        subs.append(sub)
    return subs


def solo_rerun(spec: JobSpec, steps: int, start_sub: int,
               reconfigs: List[Tuple[int, int]], device=None):
    """The job alone: ``steps`` steps through :func:`step_sub_batches`;
    final params."""
    ex = ScheduleExecutor(device=device)
    ex.submit("solo", spec, steps)
    ex.start("solo", sub_batch=start_sub)
    run = ex.runs["solo"]
    for sub in step_sub_batches(start_sub, reconfigs, steps):
        if sub != run.sub_batch:
            ex.reconfigure("solo", sub)
        ex.step_group(["solo"])
    return run.params


def solo_equal(ex: _KeepFinal, plan: SchedulePlan,
               jobs: Dict[str, Tuple[JobSpec, int]], device=None
               ) -> Dict[str, bool]:
    """Per job: are its final parameters in the replay bitwise those of
    its solo re-run?"""
    starts = start_sub_batches(plan)
    out = {}
    for name, (spec, steps) in jobs.items():
        solo = _host_params(solo_rerun(spec, steps, starts[name],
                                       ex.runs[name].reconfigs, device))
        got = ex.final[name]
        out[name] = (sorted(got) == sorted(solo)
                     and all(torch.equal(got[k], solo[k]) for k in got))
    return out


def summarize(sim, res, plan: SchedulePlan, report, payload,
              same: Dict[str, bool]) -> Dict:
    """The reference's output fields, plus the solo re-run check."""
    max_component, reconfigs = _structure(sim.log)
    rows = {}
    abs_errors = []
    for jid, job in sorted(sim.jobs.items()):
        name = NAMES[jid]
        rep = report[name]
        rows[name] = {
            "model": job.model,
            "gpus": job.gpus,
            "iters": int(job.iters),
            "final_sub_batch": rep["sub_batch"],
            "reconfigs": rep["reconfigs"],
            "predicted_exec_s": rep["predicted_exec"],
            "measured_exec_s": rep["measured_exec"],
            "error": rep["error"],
            "predicted_jct_s": plan.predicted[name]["jct"],
            "steps": rep["steps"],
        }
        abs_errors.append(abs(rep["error"]))
    return {
        "jobs": rows,
        "summary": {
            "mean_abs_error": sum(abs_errors) / len(abs_errors),
            "max_abs_error": max(abs_errors),
            "makespan_predicted_s": res.makespan,
        },
        "structure": {
            "max_sharing_group": max_component,
            "reconfig_events": reconfigs,
        },
        "solo_rerun_equal": same,
        "calibration": {
            "archs": {n: {k: e[k] for k in ("arch", "alpha_comp",
                                            "beta_comp", "t_iter_solo")}
                      for n, e in payload["archs"].items()},
            "pairs": {k: {kk: e[kk] for kk in ("xi_a", "xi_b")}
                      for k, e in payload["pairs"].items()},
            "host": payload["host"],
        },
    }


def replay(payload, specs: Dict[str, JobSpec], *, iters_a: int = 24,
           device=None) -> Dict:
    """Simulate the scenario on ``payload``, execute its plan with
    ``specs``' archs, re-run each job solo, and summarize."""
    sim, res, plan = simulate(payload, iters_a)
    jobs = job_specs(sim, specs)
    ex, report = execute(plan, jobs, device)
    same = solo_equal(ex, plan, jobs, device)
    return summarize(sim, res, plan, report, payload, same)


def specs_for_artifact(payload, *, reduced: bool, depth_fraction: float):
    """The physical jobs matching what a saved artifact measured: its
    archs, batch and seq, and its configs (names carry reduction and
    depth), or a ValueError."""
    archs = sorted(payload["archs"])
    if set(archs) != {ARCH_A, ARCH_B}:
        raise ValueError(f"artifact archs {archs} do not match the "
                         f"scenario archs {sorted((ARCH_A, ARCH_B))}")
    entries = payload["archs"]
    batches = {entries[n]["batch"] for n in archs}
    seqs = {entries[n]["seq"] for n in archs}
    if len(batches) != 1 or len(seqs) != 1:
        raise ValueError("scenario needs uniform batch/seq across the "
                         f"artifact archs, got {batches}/{seqs}")
    specs = build_specs((ARCH_A, ARCH_B), batch=batches.pop(),
                        seq=seqs.pop(), reduced=reduced,
                        depth_fraction=depth_fraction)
    for n in archs:
        if entries[n]["arch"] != specs[n].cfg.name:
            raise ValueError(
                f"artifact measured {entries[n]['arch']!r}, the replay "
                f"would train {specs[n].cfg.name!r}")
    return specs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--depth-fraction", type=float, default=None,
                    help="share of the layers kept (default: 0.5 at full "
                         "width, 1.0 with --reduced)")
    ap.add_argument("--artifact", nargs="?", const=CALIBRATION_PATH,
                    default=None, metavar="PATH",
                    help="replay against a saved calibration artifact "
                         f"(default path: {CALIBRATION_PATH})")
    args = ap.parse_args(argv)
    if args.depth_fraction is None:
        args.depth_fraction = 1.0 if args.reduced else 0.5
    t0 = time.perf_counter()
    if args.artifact:
        payload = load_artifact(args.artifact)
        specs = specs_for_artifact(payload, reduced=args.reduced,
                                   depth_fraction=args.depth_fraction)
    else:
        specs = build_specs((ARCH_A, ARCH_B), batch=4,
                            seq=32 if args.reduced else 2048,
                            reduced=args.reduced,
                            depth_fraction=args.depth_fraction)
        payload = run_calibration(specs, iters=6, device=args.device)
    out = replay(payload, specs, device=args.device)
    os.makedirs(ARTIFACTS, exist_ok=True)
    with open(REPLAY_PATH, "w") as f:
        json.dump(out, f, indent=1)
    print("Replay validation (predicted vs measured execution time)")
    print(f"{'job':<4} {'model':<14} {'iters':>5} {'b_final':>7} "
          f"{'pred (s)':>9} {'meas (s)':>9} {'error':>7} solo==")
    for name, r in out["jobs"].items():
        print(f"{name:<4} {r['model']:<14} {r['iters']:>5} "
              f"{r['final_sub_batch']:>7} {r['predicted_exec_s']:>9.3f} "
              f"{r['measured_exec_s']:>9.3f} {100 * r['error']:>6.1f}% "
              f"{out['solo_rerun_equal'][name]}")
    s = out["structure"]
    print(f"mean |error| {100 * out['summary']['mean_abs_error']:.1f}%"
          f"  max sharing group {s['max_sharing_group']}"
          f"  reconfig events {len(s['reconfig_events'])}")
    print(f"replay -> {REPLAY_PATH}")
    print(f"{time.perf_counter() - t0:.1f} s{peak_memory()}")
    return out


if __name__ == "__main__":
    main()
