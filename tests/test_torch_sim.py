"""The port's own copy of the simulator core against the reference's: the
port's ``Simulator`` + ``SJF_BSBF`` gives the reference's event log, per
job finish time and sub-batch, on the replay scenario, on seeded random
traces and under a seeded fault timeline, and its pure helpers (Eq.-3
fit, structural xi, Algorithm 2) are bitwise the reference's on seeded
inputs."""
import random

import pytest

from benchmarks.replay_validation import _structure as ref_structure
from benchmarks.replay_validation import build_scenario as ref_build_scenario
from repro.core import (ClusterState as RefCluster,
                        FaultModel as RefFaultModel,
                        InterferenceModel as RefInterference, Job as RefJob,
                        PerfParams as RefPerf, Simulator as RefSimulator,
                        paper_interference_model as ref_paper_model)
from repro.core.batch_scaling import (
    best_sharing_config as ref_best, best_sharing_config_donor_scaled as
    ref_best_donor, candidate_sub_batches as ref_candidates)
from repro.core.interference import structural_xi as ref_structural_xi
from repro.core.perf_model import fit_comp_params as ref_fit
from repro.core.schedulers import SJF_BSBF as RefSJF_BSBF
from repro_torch.core import interference, job, perf_model, schedulers
from repro_torch.core.faults import FaultModel
from repro_torch.core.batch_scaling import (best_sharing_config,
                                            best_sharing_config_donor_scaled,
                                            candidate_sub_batches)
from repro_torch.core.simulator import Simulator
from repro_torch.launch.replay import _structure, build_scenario

GB = 2 ** 30
PORT = dict(Job=job.Job, PerfParams=perf_model.PerfParams,
            ClusterState=job.ClusterState)
REF = dict(Job=RefJob, PerfParams=RefPerf, ClusterState=RefCluster)
# the reference's engines and decision paths: its heap engine is the one
# the port copies; its scan engine and vectorized (default) decision path
# are held to the same schedules by the reference's own tests
REF_PATHS = [("heap", None), ("heap", "scalar"), ("scan", None),
             ("scan", "scalar")]


def _payload():
    """A calibration artifact with made-up, H100-plausible timings."""
    def arch(name, t4, t1):
        beta = (t4 - t1) / 3
        return {"arch": name, "batch": 4, "seq": 2048, "accum_steps": 1,
                "sweep": {"sub_batches": [4, 2, 1],
                          "times": [t4, (t4 + t1) / 2, t1]},
                "alpha_comp": t1 - beta, "beta_comp": beta,
                "t_iter_solo": t4, "n_params": 10, "param_bytes": 40.0,
                "mem_base": 1.0, "mem_per_sample": 1.0}

    def pair(a, b, ta, tb):
        return {"a": a, "b": b, "t_a_solo": ta, "t_b_solo": tb,
                "t_pair": ta + tb, "xi_a": (ta + tb) / ta,
                "xi_b": (ta + tb) / tb}
    a, b = "minicpm-2b", "qwen2-vl-2b"
    return {"version": 1, "archs": {a: arch(a, 0.52, 0.21),
                                    b: arch(b, 0.31, 0.13)},
            "pairs": {f"{a}+{a}": pair(a, a, 0.52, 0.52),
                      f"{a}+{b}": pair(a, b, 0.52, 0.31),
                      f"{b}+{b}": pair(b, b, 0.31, 0.31)}}


def _random_trace(seed, mods):
    """10-20 jobs of the paper's tasks on a 2 x 4 cluster whose memory
    makes Algorithm 2 scale sub-batches."""
    rng = random.Random(seed)
    jobs = []
    t = 0.0
    for jid in range(rng.randint(10, 20)):
        t += rng.expovariate(1 / 40.0)
        perf = mods["PerfParams"](
            alpha_comp=rng.uniform(0.01, 0.1),
            beta_comp=rng.uniform(0.002, 0.02), alpha_comm=1e-3,
            beta_comm=rng.uniform(0.0, 1e-9), msg_bytes=rng.uniform(0, 4e8),
            delta=2.0, mem_base=rng.uniform(1, 5) * GB,
            mem_per_sample=rng.uniform(0.02, 0.2) * GB, param_bytes=1e8)
        jobs.append(mods["Job"](
            jid=jid, model=rng.choice(interference.PAPER_TASKS), arrival=t,
            gpus=rng.choice((1, 1, 2, 4)), iters=float(rng.randint(50, 800)),
            batch=rng.choice((8, 16, 32, 64)), perf=perf))
    return jobs, mods["ClusterState"](n_servers=2, gpus_per_server=4,
                                      gpu_capacity_bytes=11 * GB)


def _run_port(jobs, cluster, interf, donor, release, faults=None):
    sim = Simulator(cluster, jobs, schedulers.SJF_BSBF(donor_reconfig=donor),
                    interference=interf, reconfig_on_release=release,
                    fault_model=faults)
    return sim, sim.run()


def _run_ref(jobs, cluster, interf, donor, release, engine, decision,
             faults=None):
    sim = RefSimulator(cluster, jobs,
                       RefSJF_BSBF(decision=decision, donor_reconfig=donor),
                       interference=interf, reconfig_on_release=release,
                       engine=engine, fault_model=faults)
    return sim, sim.run()


def _assert_same(port, ref, exact):
    (sim, res), (rsim, rres) = port, ref
    if exact:
        assert sim.log == rsim.log
        assert res.events == rres.events
    else:
        # the scan engine accrues every job at every event, so its clock
        # differs in the last bits; the reference holds its heap and scan
        # engines to rel 1e-6 (tests/test_engine_equivalence.py)
        assert [e[1:] for e in sim.log] == [e[1:] for e in rsim.log]
        assert [e[0] for e in sim.log] == pytest.approx(
            [e[0] for e in rsim.log], rel=1e-6)
    assert len(sim.log) > 0
    for jid, j in sim.jobs.items():
        r = rsim.jobs[jid]
        if exact:
            assert j.finish_time == r.finish_time
        else:
            assert j.finish_time == pytest.approx(r.finish_time, rel=1e-6)
        assert j.sub_batch == r.sub_batch
        assert j.accum_steps == r.accum_steps


@pytest.mark.parametrize("engine,decision", REF_PATHS)
@pytest.mark.parametrize("donor,release", [(True, True), (False, False)])
def test_replay_scenario_schedule_equals_reference(engine, decision, donor,
                                                   release):
    jobs, cap = build_scenario(_payload(), iters_a=24)
    rjobs, rcap = ref_build_scenario(_payload(), iters_a=24)
    assert cap == rcap
    port = _run_port(jobs, job.ClusterState(1, 2, gpu_capacity_bytes=cap),
                     interference.InterferenceModel.from_artifact(_payload()),
                     donor, release)
    ref = _run_ref(rjobs, RefCluster(1, 2, gpu_capacity_bytes=rcap),
                   RefInterference.from_artifact(_payload()), donor, release,
                   engine, decision)
    _assert_same(port, ref, exact=True)
    kinds = [e[1] for e in port[0].log]
    assert ("reconfig" in kinds) == donor
    assert _structure(port[0].log) == ref_structure(ref[0].log, rjobs)


@pytest.mark.parametrize("engine,decision", REF_PATHS)
@pytest.mark.parametrize("model", ["paper", "structural"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_trace_schedule_equals_reference(seed, model, engine,
                                                decision):
    make = {"paper": (interference.paper_interference_model,
                      ref_paper_model),
            "structural": (interference.InterferenceModel,
                           RefInterference)}[model]
    jobs, cluster = _random_trace(seed, PORT)
    rjobs, rcluster = _random_trace(seed, REF)
    port = _run_port(jobs, cluster, make[0](), False, False)
    ref = _run_ref(rjobs, rcluster, make[1](), False, False, engine,
                   decision)
    _assert_same(port, ref, exact=engine == "heap")
    assert any(e[1] == "config" and e[3] < jobs[e[2]].batch
               for e in port[0].log), "no sub-batch was scaled"
    assert _structure(port[0].log) == ref_structure(port[0].log, jobs)
    assert _structure(port[0].log)[0] >= 3, "no job shared a GPU"


# job crashes, server failures with repairs, checkpoints every 25
# iterations and the restart penalty, dense enough that every run sees
# each kind of fault event
FAULTS = dict(job_mtbf=500.0, server_mtbf=400.0, server_repair=120.0,
              checkpoint_interval=25.0)


@pytest.mark.parametrize("engine,decision", REF_PATHS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_timeline_schedule_equals_reference(seed, engine, decision):
    jobs, cluster = _random_trace(seed, PORT)
    rjobs, rcluster = _random_trace(seed, REF)
    port = _run_port(jobs, cluster, interference.paper_interference_model(),
                     True, True, FaultModel(seed=seed, **FAULTS))
    ref = _run_ref(rjobs, rcluster, ref_paper_model(), True, True, engine,
                   decision, RefFaultModel(seed=seed, **FAULTS))
    _assert_same(port, ref, exact=engine == "heap")
    kinds = {e[1] for e in port[0].log}
    assert {"fail_job", "fail_server", "recover_server"} <= kinds
    for jid, j in port[0].jobs.items():
        r = ref[0].jobs[jid]
        assert (j.failures, j.preemptions) == (r.failures, r.preemptions)
        if engine == "heap":
            assert j.lost_iters == r.lost_iters
        else:
            assert j.lost_iters == pytest.approx(r.lost_iters, rel=1e-6,
                                                 abs=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_zero_rate_fault_model_changes_nothing(seed):
    jobs, cluster = _random_trace(seed, PORT)
    bare = _run_port(jobs, cluster, interference.paper_interference_model(),
                     True, True)
    jobs, cluster = _random_trace(seed, PORT)
    zero = _run_port(jobs, cluster, interference.paper_interference_model(),
                     True, True, FaultModel(seed=seed))
    assert bare[0].log == zero[0].log
    assert bare[1].makespan == zero[1].makespan


def test_decision_paths_not_ported_are_refused():
    """Every decision path of the reference is ported; what is refused
    is refused with the reference's message: an unknown path (by the
    policy and by the Simulator), an unknown policy, and donor rescaling
    off the scalar path."""
    with pytest.raises(ValueError, match="unknown decision path 'vector'"):
        schedulers.SJF_BSBF(decision="vector")
    jobs, cluster = _random_trace(0, PORT)
    with pytest.raises(ValueError, match="unknown decision path 'vector'"):
        Simulator(cluster, jobs, schedulers.SJF_BSBF(), decision="vector")
    with pytest.raises(ValueError, match="unknown policy 'sjf_bsbf'"):
        schedulers.make_scheduler("sjf_bsbf")
    for decision in ("grid", "batched"):
        with pytest.raises(ValueError,
                           match="donor_reconfig requires decision='scalar'"):
            schedulers.SJF_BSBF(decision=decision, donor_reconfig=True)
        assert schedulers.SJF_BSBF(decision=decision).decision == decision
    assert schedulers.SJF_BSBF(decision="scalar").donor_reconfig is False


def test_hardware_spec_states_no_tpu_numbers():
    assert not hasattr(perf_model, "TPU_V5E")
    with pytest.raises(TypeError):
        perf_model.HardwareSpec()


@pytest.mark.parametrize("seed", range(4))
def test_pure_helpers_are_bitwise_the_reference(seed):
    rng = random.Random(seed)
    bs = [float(b) for b in rng.sample(range(1, 65), rng.randint(2, 6))]
    ts = [rng.uniform(0.01, 2.0) for _ in bs]
    assert perf_model.fit_comp_params(bs, ts) == ref_fit(bs, ts)
    for _ in range(8):
        t_me, t_o = rng.uniform(1e-3, 5), rng.uniform(1e-3, 5)
        kw = dict(contention=rng.random(),
                  ratio_cap=rng.choice((None, 4.0)),
                  mem_frac=rng.uniform(0, 1.2))
        assert (interference.structural_xi(t_me, t_o, **kw)
                == ref_structural_xi(t_me, t_o, **kw))
    for batch in (1, 2, 3, 7, 16, 33, 64, 100):
        assert candidate_sub_batches(batch) == ref_candidates(batch)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("model", ["paper", "structural"])
def test_algorithm2_is_bitwise_the_reference(seed, model):
    """Algorithm 2 and its donor-rescaling extension, on random donor /
    new-job pairs under a tight and a loose capacity."""
    jobs, _ = _random_trace(seed, PORT)
    rjobs, _ = _random_trace(seed, REF)
    port_model = (interference.paper_interference_model() if model == "paper"
                  else interference.InterferenceModel())
    ref_model = ref_paper_model() if model == "paper" else RefInterference()
    rng = random.Random(seed)
    for _ in range(6):
        i, k = rng.sample(range(len(jobs)), 2)
        sub = rng.choice(candidate_sub_batches(jobs[i].batch))
        jobs[i].sub_batch = rjobs[i].sub_batch = sub
        rem = rng.uniform(1, jobs[i].iters)
        for cap in (6 * GB, 11 * GB):
            got = best_sharing_config(jobs[i], jobs[k], port_model, cap,
                                      rem_run=rem)
            want = ref_best(rjobs[i], rjobs[k], ref_model, cap, rem_run=rem)
            assert (got.share, got.sub_batch, got.accum_steps, got.avg_jct,
                    got.xi_new, got.xi_run) == (
                want.share, want.sub_batch, want.accum_steps, want.avg_jct,
                want.xi_new, want.xi_run)
            assert (got.decision is None) == (want.decision is None)
            got = best_sharing_config_donor_scaled(jobs[i], jobs[k],
                                                   port_model, cap,
                                                   rem_run=rem)
            want = ref_best_donor(rjobs[i], rjobs[k], ref_model, cap,
                                  rem_run=rem)
            assert got.__dict__ == want.__dict__
