"""The port's trace generators and task profiles against the reference's:
every generator's jobs equal the reference's field by field, perf
parameters included, for seeds 0-2; ``derive_perf_params``,
``profile_from_arch`` and the paper's task profiles are bitwise the
reference's; ``monotonicity_coefficient`` too."""
import dataclasses
import inspect
import random

import pytest

import repro.core as R
import repro_torch.core as P
from repro.core.pair import PairJob as RefPairJob
from repro.core.pair import monotonicity_coefficient as ref_mono
from repro_torch.core.pair import PairJob, monotonicity_coefficient


def _payload():
    """A calibration artifact with made-up, H100-plausible timings."""
    def arch(name, t4, t1, mem_base, mem_per_sample):
        beta = (t4 - t1) / 3
        return {"arch": name, "batch": 4, "seq": 2048, "accum_steps": 1,
                "sweep": {"sub_batches": [4, 2, 1],
                          "times": [t4, (t4 + t1) / 2, t1]},
                "alpha_comp": t1 - beta, "beta_comp": beta,
                "t_iter_solo": t4, "n_params": 10, "param_bytes": 40.0,
                "mem_base": mem_base, "mem_per_sample": mem_per_sample}
    a, b = "minicpm-2b", "qwen2-vl-2b"
    return {"version": 1, "archs": {
        a: arch(a, 0.52, 0.21, 27.3e9, 6.1e9),
        b: arch(b, 0.31, 0.13, 17.7e9, 3.9e9)}, "pairs": {}}


def _fields(job):
    out = {f.name: getattr(job, f.name)
           for f in dataclasses.fields(job) if f.compare}
    out["perf"] = dataclasses.astuple(job.perf)
    out["state"] = job.state.value
    return out


def _assert_same_jobs(port, ref):
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        assert _fields(p) == _fields(r)
        assert p.perf.t_iter(p.batch) == r.perf.t_iter(r.batch)


SEEDS = [0, 1, 2]
GENERATORS = {
    "simulation": lambda m, s: m.simulation_trace(n_jobs=120, seed=s),
    "simulation-480-load": lambda m, s: m.simulation_trace(
        n_jobs=480, seed=s, load_scale=1.7),
    "physical": lambda m, s: m.physical_trace(seed=s),
    "datacenter": lambda m, s: m.datacenter_trace(n_jobs=500, seed=s,
                                                  n_gpus=256),
    "philly": lambda m, s: m.philly_trace(n_jobs=500, seed=s, n_gpus=1024,
                                          utilization=0.77),
    "calibrated": lambda m, s: m.calibrated_trace(_payload(), n_jobs=30,
                                                  seed=s, load=6.0),
    "generate-config": lambda m, s: m.generate_trace(m.TraceConfig(
        n_jobs=60, seed=s, mean_interarrival=45.0, log_uniform_iters=False,
        task_weights={"bert": 3.0, "ncf": 0.5})),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_generator_equals_reference(kind, seed):
    _assert_same_jobs(GENERATORS[kind](P, seed), GENERATORS[kind](R, seed))


def test_generators_default_to_the_papers_card():
    for fn in (P.datacenter_trace, P.philly_trace, P.simulation_trace):
        assert inspect.signature(fn).parameters["hw"].default is \
            P.GPU_2080TI
    assert P.TraceConfig().hw is P.GPU_2080TI   # generate_trace's
    assert dataclasses.astuple(P.GPU_2080TI) == \
        dataclasses.astuple(R.GPU_2080TI)


def test_paper_task_profiles_are_the_references():
    assert sorted(P.PAPER_TASK_PROFILES) == sorted(R.PAPER_TASK_PROFILES)
    for name, prof in P.PAPER_TASK_PROFILES.items():
        ref = R.PAPER_TASK_PROFILES[name]
        assert dataclasses.astuple(prof) == dataclasses.astuple(ref)
        for n in (1, 2, 3, 4, 8, 12, 16, 64, 128):
            assert dataclasses.astuple(prof.perf_params(n)) == \
                dataclasses.astuple(ref.perf_params(n))


@pytest.mark.parametrize("seed", SEEDS)
def test_derive_perf_params_is_bitwise_the_reference(seed):
    rng = random.Random(seed)
    for _ in range(20):
        kw = dict(flops_per_sample=rng.uniform(1e8, 1e12),
                  param_bytes=rng.uniform(1e6, 1e10),
                  n_workers=rng.choice((1, 2, 3, 4, 8, 16, 100)),
                  act_bytes_per_sample=rng.uniform(1e4, 1e9),
                  opt_bytes=rng.uniform(0, 1e10),
                  delta=rng.choice((1.0, 2.0, 3.5)),
                  kernel_overhead=rng.uniform(0, 1e-2))
        hw = dict(peak_flops=rng.uniform(1e12, 1e15),
                  hbm_bytes_per_s=rng.uniform(1e11, 4e12),
                  link_bytes_per_s=rng.uniform(1e9, 1e11),
                  mem_capacity=rng.uniform(8, 80) * 2 ** 30,
                  alpha_comm=rng.uniform(1e-6, 1e-4),
                  mfu=rng.uniform(0.1, 0.6))
        got = P.derive_perf_params(hw=P.HardwareSpec(**hw), **kw)
        want = R.derive_perf_params(hw=R.HardwareSpec(**hw), **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("seed", SEEDS)
def test_profile_from_arch_is_bitwise_the_reference(seed):
    rng = random.Random(seed)
    kw = dict(n_params=rng.uniform(1e8, 4e11),
              n_active_params=rng.uniform(1e8, 2e10),
              seq_len=rng.choice((512, 2048, 4096)),
              batch=rng.choice((1, 2, 4, 8)),
              act_bytes_per_token=rng.uniform(1e3, 1e6))
    got = P.profile_from_arch("arch", **kw)
    want = R.profile_from_arch("arch", **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for n in (1, 4, 16):
        assert dataclasses.astuple(got.perf_params(n)) == \
            dataclasses.astuple(want.perf_params(n))


@pytest.mark.parametrize("seed", SEEDS)
def test_monotonicity_coefficient_is_the_references(seed):
    rng = random.Random(seed)
    for _ in range(20):
        a = (rng.uniform(0.01, 2), rng.uniform(1, 1e4), rng.uniform(1, 6))
        b = (rng.uniform(0.01, 2), rng.uniform(1, 1e4), rng.uniform(1, 6))
        assert monotonicity_coefficient(PairJob(*a), PairJob(*b)) == \
            ref_mono(RefPairJob(*a), RefPairJob(*b))
