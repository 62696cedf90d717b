"""SJF-BSBF's three decision paths in the port, and its two engines.

* grid == batched == scalar, record for record, on seeded
  ``simulation_trace`` runs, small datacenter and Philly traces, and the
  reference's fuzz regression corpus (``REGRESSION_SPECS`` of
  ``tests/test_engine_equivalence.py``, whose chaos preempts,
  reconfigures and fails jobs and servers mid-run);
* the port's grid log == the reference's grid log on the same inputs;
* the port's scan engine == its heap engine on the corpus, for every
  policy, within the reference's own tolerance (rel 1e-6);
* the spec on which the reference's batched path reads a donor's
  sub-batch from before a reconfiguration: the port's batched log is
  its scalar log (and the reference's scalar log).

A fixed, seeded corpus: no example is drawn at random."""
import random

import pytest

import repro.core as R
import repro_torch.core as P
from test_engine_equivalence import REGRESSION_SPECS
from test_engine_equivalence import _fuzz_run as ref_fuzz_run

GB = 2 ** 30
PATHS = ("scalar", "grid", "batched")
REL = 1e-6
# the reference's batched path departs from its scalar and grid paths
# here, at (202.92, 'config', 5, ...): job 5 takes sub-batch 8 beside a
# donor whose sub-batch a reconfiguration had just halved
STALE_DONOR = ("stale-donor-after-reconfig",
               ((0, 0, 1, 20), (1, 0, 1, 20), (1, 5, 1, 301),
                (16066, 0, 1, 20), (4223, 3, 16, 20), (1, 0, 1, 20)),
               (0, 2, 2, 0, 0))
CORPUS = list(REGRESSION_SPECS) + [STALE_DONOR]
IDS = [c[0] for c in CORPUS]


class ChaosScheduler:
    """Wraps a policy and, after every scheduling pass, deterministically
    injects the mutations schedulers are allowed to make — preempting a
    running job, shrinking a running job's sub-batch mid-run
    (``reconfigure_job``), failing a job or a server — from a seeded RNG
    (a copy of the reference's harness). The injection sequence depends
    only on the pass count and the (sorted) running set, so two
    simulators producing identical schedules receive identical chaos."""

    FAULT_BUDGET = 20

    def __init__(self, inner, chaos_seed, preempt_every, reconfig_every,
                 fail_every=0, server_fail_every=0):
        self.inner = inner
        self.name = inner.name
        self.preemptive = inner.preemptive
        self.tick_interval = inner.tick_interval
        self.tick_only = inner.tick_only
        self.reads_running_progress = inner.reads_running_progress
        self.progress_scope = inner.progress_scope
        self._seed = chaos_seed
        self._preempt_every = preempt_every
        self._reconfig_every = reconfig_every
        self._fail_every = fail_every
        self._server_fail_every = server_fail_every
        self.reset()

    def reset(self):
        self.inner.reset()
        self._rng = random.Random(self._seed)
        self._passes = 0
        self._fails_left = self.FAULT_BUDGET
        self._server_fails_left = self.FAULT_BUDGET

    def schedule(self, sim):
        self.inner.schedule(sim)
        self._passes += 1
        rng = self._rng
        if self._preempt_every and self._passes % self._preempt_every == 0:
            running = sorted(sim.running)
            if running:
                sim.preempt_job(sim.running[
                    running[rng.randrange(len(running))]])
                self.inner.schedule(sim)
        if self._reconfig_every and self._passes % self._reconfig_every == 0:
            running = sorted(sim.running)
            if running:
                job = sim.running[running[rng.randrange(len(running))]]
                if job.sub_batch > 1:
                    sim.reconfigure_job(job, (job.sub_batch + 1) // 2)
        if (self._fail_every and self._fails_left
                and self._passes % self._fail_every == 0):
            running = sorted(sim.running)
            if running:
                self._fails_left -= 1
                sim.fail_job(sim.running[
                    running[rng.randrange(len(running))]])
                self.inner.schedule(sim)
        if (self._server_fail_every and self._server_fails_left
                and self._passes % self._server_fail_every == 0):
            self._server_fails_left -= 1
            sim.fail_server(rng.randrange(sim.cluster.n_servers),
                            repair_after=120.0)
            self.inner.schedule(sim)


def _jobs_from_spec(spec):
    names = sorted(P.PAPER_TASK_PROFILES)
    jobs, t = [], 0.0
    for jid, (gap_cs, model_i, gpus, iters) in enumerate(spec):
        t += gap_cs / 100.0
        name = names[model_i % len(names)]
        prof = P.PAPER_TASK_PROFILES[name]
        jobs.append(P.Job(jid=jid, model=name, arrival=t, gpus=gpus,
                          iters=float(iters), batch=prof.default_batch,
                          perf=prof.perf_params(gpus, P.GPU_2080TI)))
    return jobs


def _fuzz_run(spec, chaos, policy, engine, decision=None):
    """The port's twin of the reference's ``_fuzz_run``."""
    sched = ChaosScheduler(P.make_scheduler(policy), *chaos)
    sim = P.Simulator(P.ClusterState(n_servers=4, gpus_per_server=4,
                                     gpu_capacity_bytes=11 * GB),
                      _jobs_from_spec(spec), sched,
                      interference=P.paper_interference_model(),
                      engine=engine, decision=decision, max_events=500_000,
                      fault_model=P.FaultModel(checkpoint_interval=50.0))
    res = sim.run()
    return res, list(sim.log), res.summary()


def _assert_close(a, b):
    """The reference's heap-vs-scan tolerance."""
    assert a.events == b.events
    sa, sb = a.summary(), b.summary()
    for key, val in sa.items():
        assert sb[key] == pytest.approx(val, rel=REL, abs=REL), key
    for ja, jb in zip(sorted(a.jobs, key=lambda j: j.jid),
                      sorted(b.jobs, key=lambda j: j.jid)):
        assert jb.finish_time == pytest.approx(ja.finish_time, rel=REL)
        assert jb.waiting_time == pytest.approx(ja.waiting_time,
                                                rel=REL, abs=1e-3)
        assert (jb.preemptions, jb.failures) == (ja.preemptions,
                                                 ja.failures)
        assert jb.lost_iters == pytest.approx(ja.lost_iters,
                                              rel=REL, abs=1e-3)


@pytest.mark.parametrize("case", CORPUS, ids=IDS)
def test_decision_paths_equal_on_corpus(case):
    _, spec, chaos = case
    runs = {d: _fuzz_run(spec, chaos, "sjf-bsbf", "heap", d)
            for d in PATHS}
    for d in ("grid", "batched"):
        assert runs[d][1] == runs["scalar"][1], d
        assert runs[d][2] == runs["scalar"][2], d
    assert len(runs["scalar"][1]) > 0


@pytest.mark.parametrize("case", CORPUS, ids=IDS)
def test_port_grid_equals_reference_grid_on_corpus(case):
    _, spec, chaos = case
    _, log, summary = _fuzz_run(spec, chaos, "sjf-bsbf", "heap", "grid")
    _, ref_log, ref_summary = ref_fuzz_run(spec, chaos, "sjf-bsbf", "heap",
                                           "grid")
    assert log == ref_log
    assert summary == ref_summary


@pytest.mark.parametrize("policy", sorted(P.ALL_POLICIES))
@pytest.mark.parametrize("case", CORPUS, ids=IDS)
def test_scan_matches_heap_on_corpus(case, policy):
    _, spec, chaos = case
    heap, _, _ = _fuzz_run(spec, chaos, policy, "heap")
    scan, _, _ = _fuzz_run(spec, chaos, policy, "scan")
    _assert_close(scan, heap)


def test_batched_rereads_a_reconfigured_donor():
    """A reconfiguration changes a donor's sub-batch without a
    placement: the port's batched path must not keep the donor's old
    memory and iteration time. Its log is its scalar log, which is the
    reference's scalar log."""
    _, spec, chaos = STALE_DONOR
    _, batched, _ = _fuzz_run(spec, chaos, "sjf-bsbf", "heap", "batched")
    _, scalar, _ = _fuzz_run(spec, chaos, "sjf-bsbf", "heap", "scalar")
    _, ref_scalar, _ = ref_fuzz_run(spec, chaos, "sjf-bsbf", "heap",
                                    "scalar")
    assert batched == scalar == ref_scalar
    assert (202.92, "config", 5, 32, 1) in batched
    assert any(e[1] == "reconfig" for e in batched)


def _trace_runs(make, servers, gpus, model, decision, mod):
    interference = (mod.paper_interference_model() if model == "paper"
                    else mod.InterferenceModel())
    sim = mod.Simulator(mod.ClusterState(servers, gpus,
                                         gpu_capacity_bytes=11 * GB),
                        make(mod), mod.SJF_BSBF(decision=decision),
                        interference=interference)
    res = sim.run()
    return list(sim.log), res.summary()


TRACES = {
    "simulation-0": (lambda m: m.simulation_trace(n_jobs=120, seed=0),
                     16, 4),
    "simulation-1": (lambda m: m.simulation_trace(n_jobs=120, seed=1),
                     16, 4),
    "simulation-2": (lambda m: m.simulation_trace(n_jobs=120, seed=2),
                     16, 4),
    "datacenter": (lambda m: m.datacenter_trace(n_jobs=400, seed=0,
                                                n_gpus=128), 16, 8),
    "philly": (lambda m: m.philly_trace(n_jobs=400, seed=1, n_gpus=128),
               16, 8),
}


@pytest.mark.parametrize("model", ["paper", "structural"])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_decision_paths_equal_on_traces(trace, model):
    make, servers, gpus = TRACES[trace]
    runs = {d: _trace_runs(make, servers, gpus, model, d, P) for d in PATHS}
    assert runs["grid"] == runs["scalar"]
    assert runs["batched"] == runs["scalar"]
    assert runs["grid"] == _trace_runs(make, servers, gpus, model, "grid", R)
    assert _shared_starts(runs["scalar"][0]) > 0


def _shared_starts(log):
    """Starts onto a GPU that another job holds (sharing decisions)."""
    on, where, n = {}, {}, 0
    for e in log:
        if e[1] == "start":
            n += any(on.get(g) for g in e[3])
            where[e[2]] = e[3]
            for g in e[3]:
                on.setdefault(g, set()).add(e[2])
        elif e[1] in ("finish", "preempt", "fail_job"):
            for g in where.pop(e[2]):
                on[g].discard(e[2])
    return n


def test_refused_decision_names():
    with pytest.raises(ValueError, match="unknown decision path 'fast'"):
        P.SJF_BSBF(decision="fast")
    with pytest.raises(ValueError, match="unknown decision path 'fast'"):
        P.Simulator(P.ClusterState(1, 1), [], P.SJF_BSBF(), decision="fast")
    with pytest.raises(ValueError, match="unknown simulator engine 'btree'"):
        P.Simulator(P.ClusterState(1, 1), [], P.SJF_BSBF(), engine="btree")
    sim = P.Simulator(P.ClusterState(1, 1), [], P.SJF_BSBF())
    assert (sim.engine_name, sim.decision_path) == ("heap", "scalar")
