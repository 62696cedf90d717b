"""The port's seven policies against the reference's: FIFO, SJF, SRSF,
Tiresias, PolluxLike, SJF-FFS and SJF-BSBF each give the reference's
event log, finish times, sub-batches, allocations and preemption counts,
equal (``==``), on seeded paper traces and random traces under the
paper's and the structural interference models, under a seeded fault
timeline with dynamic server failures and their repairs, and with
Tiresias' and PolluxLike's ticks at other intervals; on both engines.
Also the incremental order's re-key on a requeued job and the heap
engine's deadlock detection."""
import random

import pytest

import repro.core as R
import repro_torch.core as P
from repro_torch.core.job import Job, JobState
from repro_torch.core.perf_model import PerfParams
from repro_torch.core.schedulers import _StaticOrder

GB = 2 ** 30
POLICIES = sorted(R.ALL_POLICIES)


def _random_trace(mod, seed):
    """12-24 jobs of the paper's tasks with random demands, iterations
    and batches; perf from each task's profile at its demand."""
    rng = random.Random(seed)
    names = sorted(mod.PAPER_TASK_PROFILES)
    jobs, t = [], 0.0
    for jid in range(rng.randint(12, 24)):
        t += rng.expovariate(1 / 60.0)
        name = rng.choice(names)
        prof = mod.PAPER_TASK_PROFILES[name]
        gpus = rng.choice((1, 1, 2, 4, 8))
        jobs.append(mod.Job(
            jid=jid, model=name, arrival=t, gpus=gpus,
            iters=float(rng.randint(100, 3000)),
            batch=rng.choice((prof.default_batch, 2 * prof.default_batch)),
            perf=prof.perf_params(gpus, mod.GPU_2080TI)))
    return jobs


class Chaos:
    """Wraps a policy and fails a seeded server every few passes with a
    repair on the fault heap (``fail_server(repair_after=)``); the same
    class drives both packages' simulators."""

    def __init__(self, inner, seed, every=4, budget=6):
        self.inner = inner
        for k in ("name", "preemptive", "tick_interval", "tick_only",
                  "reads_running_progress", "progress_scope"):
            setattr(self, k, getattr(inner, k))
        self._seed, self._every, self._budget = seed, every, budget
        self.reset()

    def reset(self):
        self.inner.reset()
        self._rng = random.Random(self._seed)
        self._passes = 0
        self._left = self._budget

    def schedule(self, sim):
        self.inner.schedule(sim)
        self._passes += 1
        if self._left and self._passes % self._every == 0:
            self._left -= 1
            sim.fail_server(self._rng.randrange(sim.cluster.n_servers),
                            repair_after=90.0)
            self.inner.schedule(sim)


def _run(mod, jobs, scheduler, *, servers=4, gpus=4, model="paper",
         engine="heap", faults=None, chaos=None):
    interference = (mod.paper_interference_model() if model == "paper"
                    else mod.InterferenceModel())
    if chaos is not None:
        scheduler = Chaos(scheduler, chaos)
    kw = {"decision": "scalar"} if mod is R else {}
    sim = mod.Simulator(mod.ClusterState(servers, gpus,
                                         gpu_capacity_bytes=11 * GB),
                        jobs, scheduler, interference=interference,
                        engine=engine, fault_model=faults, **kw)
    return sim, sim.run()


def _assert_equal(port, ref):
    (sim, res), (rsim, rres) = port, ref
    assert len(sim.log) > 0
    assert sim.log == rsim.log
    assert res.events == rres.events
    assert res.makespan == rres.makespan
    assert res.summary() == rres.summary()
    for jid, j in sim.jobs.items():
        r = rsim.jobs[jid]
        assert j.state is JobState.FINISHED
        assert (j.finish_time, j.first_start_time, j.sub_batch,
                j.accum_steps, j.alloc_gpus, j.preemptions, j.failures,
                j.waiting_time, j.lost_iters, j.attained_service) == (
            r.finish_time, r.first_start_time, r.sub_batch, r.accum_steps,
            r.alloc_gpus, r.preemptions, r.failures, r.waiting_time,
            r.lost_iters, r.attained_service)


@pytest.mark.parametrize("engine", ["heap", "scan"])
@pytest.mark.parametrize("model", ["paper", "structural"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulation_trace_equals_reference(policy, seed, model, engine):
    port = _run(P, P.simulation_trace(n_jobs=40, seed=seed),
                P.make_scheduler(policy), model=model, engine=engine)
    ref = _run(R, R.simulation_trace(n_jobs=40, seed=seed),
               R.make_scheduler(policy), model=model, engine=engine)
    _assert_equal(port, ref)


@pytest.mark.parametrize("model", ["paper", "structural"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_random_trace_equals_reference(policy, seed, model):
    port = _run(P, _random_trace(P, seed), P.make_scheduler(policy),
                servers=2, model=model)
    ref = _run(R, _random_trace(R, seed), R.make_scheduler(policy),
               servers=2, model=model)
    _assert_equal(port, ref)


# job crashes and server failures with repairs from the seeded timeline,
# checkpoints every 50 iterations, dense enough for every kind of event
FAULTS = dict(job_mtbf=900.0, server_mtbf=700.0, server_repair=150.0,
              checkpoint_interval=50.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_fault_timeline_equals_reference(policy, seed):
    port = _run(P, _random_trace(P, seed), P.make_scheduler(policy),
                servers=2, faults=P.FaultModel(seed=seed, **FAULTS),
                chaos=seed)
    ref = _run(R, _random_trace(R, seed), R.make_scheduler(policy),
               servers=2, faults=R.FaultModel(seed=seed, **FAULTS),
               chaos=seed)
    _assert_equal(port, ref)
    kinds = {e[1] for e in port[0].log}
    assert {"fail_server", "recover_server"} <= kinds


@pytest.mark.parametrize("kw", [
    {"tick_interval": 30.0}, {"tick_interval": 240.0},
    {"tick_interval": 60.0, "threshold_gpu_seconds": 600.0}])
def test_tiresias_ticks_equal_reference(kw):
    port = _run(P, P.simulation_trace(n_jobs=40, seed=3), P.Tiresias(**kw))
    ref = _run(R, R.simulation_trace(n_jobs=40, seed=3), R.Tiresias(**kw))
    _assert_equal(port, ref)
    assert any(e[1] == "preempt" for e in port[0].log)


@pytest.mark.parametrize("kw", [
    {"tick_interval": 30.0}, {"tick_interval": 240.0},
    {"tick_interval": 60.0, "min_gpus": 2}])
def test_pollux_ticks_equal_reference(kw):
    port = _run(P, P.simulation_trace(n_jobs=40, seed=3), P.PolluxLike(**kw))
    ref = _run(R, R.simulation_trace(n_jobs=40, seed=3), R.PolluxLike(**kw))
    _assert_equal(port, ref)
    # elastic: some job ran on fewer GPUs than it asked for
    assert any(j.alloc_gpus not in (None, j.gpus)
               for j in port[0].jobs.values())


def test_policy_table_matches_reference():
    assert sorted(P.ALL_POLICIES) == sorted(R.ALL_POLICIES)
    for name in P.ALL_POLICIES:
        port, ref = P.make_scheduler(name), R.make_scheduler(name)
        assert port.name == ref.name == name
        for attr in ("preemptive", "tick_interval", "tick_only",
                     "reads_running_progress", "progress_scope"):
            assert getattr(port, attr) == getattr(ref, attr), (name, attr)
    with pytest.raises(ValueError, match="unknown policy 'lottery'"):
        P.make_scheduler("lottery")


def test_static_order_rekeys_requeued_jobs():
    """A job re-entering the queue after a preemption may carry a new
    sort key; the incremental order must detect it (via the preemption
    count) instead of replaying the stale position."""
    def mk(jid, iters):
        perf = PerfParams(alpha_comp=0.0, beta_comp=1e-2, alpha_comm=0.0,
                          beta_comm=0.0, msg_bytes=0.0)
        return Job(jid=jid, model="m", arrival=0.0, gpus=1, iters=iters,
                   batch=10, perf=perf)

    a, b = mk(0, 100.0), mk(1, 200.0)
    order = _StaticOrder(lambda j: j.expected_remaining_time)
    assert order.order([a, b]) == [a, b]
    # b runs, progresses past a's remaining work, and is preempted
    b.state = JobState.RUNNING
    assert order.order([a]) == [a]
    b.iters_done = 150.0
    b.preemptions += 1
    b.state = JobState.PENDING
    assert order.order([a, b]) == [b, a]   # stale key would say [a, b]


@pytest.mark.parametrize("engine", ["heap", "scan"])
def test_deadlock_detection(engine):
    """A job larger than the cluster, no ticks to hide behind: both
    engines raise the reference's diagnostic."""
    jobs = P.simulation_trace(n_jobs=3, seed=1)
    max(jobs, key=lambda j: j.gpus).gpus = 999
    sim = P.Simulator(P.ClusterState(n_servers=4, gpus_per_server=4), jobs,
                      P.make_scheduler("fifo"), engine=engine)
    with pytest.raises(RuntimeError, match="deadlock"):
        sim.run()


def test_core_exports_the_references_names():
    assert set(P.__all__) == set(R.__all__) - {"TPU_V5E"}
    assert not hasattr(P, "TPU_V5E")
