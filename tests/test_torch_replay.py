"""Plan replay: the port's ``plan_from_sim`` gives the reference's plan on
the same schedule, and the port's executor runs it on reduced f32
configs on the CPU with every job taking exactly ``job.iters`` steps,
reconfigurations where the plan puts them, and final parameters bitwise
those of each job's solo re-run (sharing changes no job's training)."""
import dataclasses
import math

import pytest

from repro.core import (ClusterState as RefCluster,
                        InterferenceModel as RefInterference, Job as RefJob,
                        PerfParams as RefPerf, Simulator as RefSimulator)
from repro.core.schedulers import SJF_BSBF as RefSJF_BSBF
from repro.launch.cluster import JobRun as RefJobRun
from repro.launch.cluster import plan_from_sim as ref_plan_from_sim
from repro_torch.core.interference import InterferenceModel
from repro_torch.core.job import ClusterState, Job
from repro_torch.core.perf_model import PerfParams
from repro_torch.core.schedulers import SJF_BSBF
from repro_torch.core.simulator import Simulator
from repro_torch.launch import replay
from repro_torch.launch.calibrate import build_specs
from repro_torch.launch.cluster import (PlanOp, PlanPhase, ScheduleExecutor,
                                        SchedulePlan, plan_from_sim)
from _torch_threads import one_torch_thread  # noqa: F401

GB = 2 ** 30
NAMES = {0: "A", 1: "B", 2: "C", 3: "D"}


def _scenario(mods, iters_a=30):
    """The reference's ``tests/test_schedule_executor.py::_scenario``:
    donor A on both GPUs, short sharers B/C (a 3-way group; B's admission
    needs the donor-rescaling extension), late D queues."""
    Perf, JobCls, Interf = mods

    def perf(alpha=0.01, beta=0.01):
        return Perf(alpha_comp=alpha, beta_comp=beta, alpha_comm=0.0,
                    beta_comm=0.0, msg_bytes=0.0, delta=2.0,
                    mem_base=4.0 * GB, mem_per_sample=0.25 * GB,
                    param_bytes=1e8, n_workers=1)
    pa, pb = perf(), perf(beta=0.008)
    t_a = pa.t_iter(4)
    jobs = [
        JobCls(jid=0, model="m0", arrival=0.0, gpus=2, iters=float(iters_a),
               batch=4, perf=pa),
        JobCls(jid=1, model="m1", arrival=2 * t_a, gpus=1, iters=3.0,
               batch=4, perf=pb),
        JobCls(jid=2, model="m1", arrival=4 * t_a, gpus=1, iters=4.0,
               batch=4, perf=pb),
        JobCls(jid=3, model="m0", arrival=6 * t_a, gpus=1, iters=3.0,
               batch=4, perf=pa),
    ]
    cap = pa.mem_bytes(2) + pb.mem_bytes(2) + 0.25 * 0.25 * GB
    interf = Interf()
    for a in ("m0", "m1"):
        for b in ("m0", "m1"):
            interf.set_pair(a, b, 1.3, 1.3)
    return jobs, cap, interf


def _plan(port: bool):
    mods = ((PerfParams, Job, InterferenceModel) if port
            else (RefPerf, RefJob, RefInterference))
    jobs, cap, interf = _scenario(mods)
    if port:
        sim = Simulator(ClusterState(1, 2, gpu_capacity_bytes=cap), jobs,
                        SJF_BSBF(donor_reconfig=True), interference=interf,
                        reconfig_on_release=True)
    else:
        sim = RefSimulator(RefCluster(1, 2, gpu_capacity_bytes=cap), jobs,
                           RefSJF_BSBF(donor_reconfig=True),
                           interference=interf, reconfig_on_release=True)
    sim.run()
    make = plan_from_sim if port else ref_plan_from_sim
    return sim, make(sim.log, sim.jobs, interf, cap, names=NAMES)


def _phases(plan):
    return [(tuple((op.kind, op.job, op.sub_batch) for op in p.ops),
             p.quotas, p.groups, p.sim_duration) for p in plan.phases]


def test_plan_equals_the_reference():
    sim, plan = _plan(port=True)
    rsim, ref = _plan(port=False)
    assert sim.log == rsim.log
    assert _phases(plan) == _phases(ref)
    assert plan.predicted == ref.predicted
    # the reference's plan from the port's log, too
    same_log = ref_plan_from_sim(sim.log, sim.jobs, sim.interference,
                                 sim.cluster.gpu_capacity_bytes, names=NAMES)
    assert _phases(same_log) == _phases(plan)
    totals = {}
    for phase in plan.phases:
        for name, q in phase.quotas:
            assert q >= 0
            totals[name] = totals.get(name, 0) + q
    assert totals == {"A": 30, "B": 3, "C": 4, "D": 3}
    assert max(len(g) for p in plan.phases for g in p.groups) == 3
    kinds = [(op.kind, op.job) for p in plan.phases for op in p.ops]
    assert kinds.count(("finish", "A")) == 1 and ("reconfig", "A") in kinds
    assert sum(p.sim_duration for p in plan.phases) == pytest.approx(
        max(j.finish_time for j in sim.jobs.values()))


def test_plan_refuses_a_preemptive_log():
    jobs, cap, interf = _scenario((PerfParams, Job, InterferenceModel))
    log = [(0.0, "start", 0, [0, 1]), (0.0, "config", 0, 4, 1),
           (1.0, "preempt", 0)]
    with pytest.raises(ValueError, match="non-preemptive"):
        plan_from_sim(log, {0: jobs[0]}, interf, cap)


def test_execute_reports_predicted_against_measured():
    ex = ScheduleExecutor(device="cpu")
    spec = build_specs(("minicpm-2b",), seq=16, reduced=True)["minicpm-2b"]
    ex.submit("a", spec, 2)
    plan = SchedulePlan(
        phases=[PlanPhase(ops=(PlanOp("start", "a", 2),), quotas=(("a", 2),),
                          groups=(("a",),), sim_duration=1.5),
                PlanPhase(ops=(PlanOp("finish", "a"),), quotas=(),
                          groups=())],
        predicted={"a": {"exec_seconds": 1.5, "jct": 2.0}})
    rep = ex.execute(plan)["a"]
    assert rep["predicted_exec"] == 1.5
    assert rep["measured_exec"] == rep["walltime"] > 0
    assert rep["error"] == (rep["walltime"] - 1.5) / 1.5


@pytest.fixture(scope="module")
def replayed():
    """The replay scenario on reduced f32 configs at seq 32, iters_a 24,
    from a fixed artifact (made-up timings) so the schedule is the same
    on every run."""
    payload = {"version": 1, "host": {"backend": "cpu"}, "archs": {},
               "pairs": {}}
    for name, (t4, t1) in (("minicpm-2b", (0.52, 0.21)),
                           ("qwen2-vl-2b", (0.31, 0.13))):
        beta = (t4 - t1) / 3
        payload["archs"][name] = {
            "arch": name, "batch": 4, "seq": 32, "alpha_comp": t1 - beta,
            "beta_comp": beta, "t_iter_solo": t4, "param_bytes": 1.0,
            "mem_base": 1.0, "mem_per_sample": 1.0}
    for a, b, xa, xb in (("minicpm-2b", "minicpm-2b", 2.0, 2.0),
                         ("minicpm-2b", "qwen2-vl-2b", 1.6, 2.7),
                         ("qwen2-vl-2b", "qwen2-vl-2b", 2.0, 2.0)):
        payload["pairs"][f"{a}+{b}"] = {"a": a, "b": b, "xi_a": xa,
                                        "xi_b": xb}
    specs = build_specs(("minicpm-2b", "qwen2-vl-2b"), seq=32, reduced=True)
    sim, res, plan = replay.simulate(payload, iters_a=24)
    jobs = replay.job_specs(sim, specs)
    ex, report = replay.execute(plan, jobs, device="cpu")
    same = replay.solo_equal(ex, plan, jobs, device="cpu")
    out = replay.summarize(sim, res, plan, report, payload, same)
    return sim, plan, ex, report, same, out


def test_replay_steps_and_reconfigs_follow_the_plan(replayed):
    sim, plan, ex, report, _, out = replayed
    assert out["structure"]["max_sharing_group"] == 3
    for jid, job in sim.jobs.items():
        name = NAMES[jid]
        assert report[name]["steps"] == int(job.iters)
        assert ex.runs[name].finished
    # each reconfig op fires after the steps the plan gave before it
    done, want = {}, {}
    for phase in plan.phases:
        for op in phase.ops:
            if op.kind == "reconfig":
                want.setdefault(op.job, []).append((done.get(op.job, 0),
                                                    op.sub_batch))
        for name, q in phase.quotas:
            done[name] = done.get(name, 0) + q
    assert want["A"] == [(want["A"][0][0], 2), (want["A"][1][0], 4)]
    for name in NAMES.values():
        assert report[name]["reconfigs"] == want.get(name, [])
    assert done == {NAMES[j]: int(job.iters) for j, job in sim.jobs.items()}


def test_replay_report_has_the_reference_keys(replayed):
    _, _, _, report, _, out = replayed
    ref_keys = set(RefJobRun(name="x", spec=None, total_steps=1).report())
    want = ref_keys | {"loss", "predicted_exec", "measured_exec", "error"}
    for rep in report.values():
        assert set(rep) == want
        assert math.isfinite(rep["error"]) and rep["measured_exec"] > 0
    assert set(out["summary"]) == {"mean_abs_error", "max_abs_error",
                                   "makespan_predicted_s"}
    assert out["summary"]["max_abs_error"] == max(
        abs(r["error"]) for r in out["jobs"].values())


def test_sharing_changes_no_jobs_training(replayed):
    _, _, ex, _, same, _ = replayed
    assert same == {"A": True, "B": True, "C": True, "D": True}
    assert all(len(p) > 0 for p in ex.final.values())


def test_solo_equal_sees_a_changed_bit(replayed):
    sim, plan, ex, _, _, _ = replayed
    spec, steps = replay.job_specs(
        sim, build_specs(("minicpm-2b", "qwen2-vl-2b"), seq=32,
                         reduced=True))["B"]
    key = sorted(ex.final["B"])[0]
    kept = ex.final["B"][key]
    ex.final["B"][key] = kept.clone()
    ex.final["B"][key].view(-1)[0] += 1.0
    try:
        assert replay.solo_equal(ex, plan, {"B": (spec, steps)},
                                 device="cpu") == {"B": False}
    finally:
        ex.final["B"][key] = kept


def test_artifact_must_match_the_replayed_jobs():
    payload = {"archs": {n: {"arch": f"{n}-reduced", "batch": 4, "seq": 32}
                         for n in ("minicpm-2b", "qwen2-vl-2b")}}
    specs = replay.specs_for_artifact(payload, reduced=True,
                                      depth_fraction=1.0)
    assert specs["qwen2-vl-2b"].seq == 32
    with pytest.raises(ValueError, match="would train"):
        replay.specs_for_artifact(payload, reduced=False, depth_fraction=1.0)
    bad = {"archs": dict(payload["archs"], other=payload["archs"]
                         ["minicpm-2b"])}
    with pytest.raises(ValueError, match="scenario archs"):
        replay.specs_for_artifact(bad, reduced=True, depth_fraction=1.0)


def test_depth_cut_names_its_layers():
    specs = build_specs(("minicpm-2b", "qwen2-vl-2b"), depth_fraction=0.5)
    cfgs = {n: s.cfg for n, s in specs.items()}
    assert (cfgs["minicpm-2b"].n_layers, cfgs["minicpm-2b"].name) == (
        20, "minicpm-2b@20")
    assert (cfgs["qwen2-vl-2b"].n_layers, cfgs["qwen2-vl-2b"].name) == (
        14, "qwen2-vl-2b@14")
    assert cfgs["qwen2-vl-2b"].d_model == 1536
    assert dataclasses.replace(cfgs["minicpm-2b"], n_layers=40,
                               name="minicpm-2b") == build_specs(
        ("minicpm-2b",))["minicpm-2b"].cfg
