"""The port's schedule executor and co-schedule measurements on the CPU
(reduced configs, f32): group steps, reconfiguration, plans, and the
rule that entry points never fall back to the CPU on their own."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.coschedule import (measure_group, measure_pair,
                                         measure_solo)
from repro_torch.data import make_batch
from repro_torch.launch.cluster import (JobSpec, PlanOp, PlanPhase,
                                        ScheduleExecutor,
                                        accum_for_sub_batch,
                                        make_group_step)
from repro_torch.models import init_params
from repro_torch.train import TrainConfig, adamw_init, make_train_step
from repro_torch.tree import flatten
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


def _spec(name, batch=4, seed=0, **kw):
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    return JobSpec(cfg, batch=batch, seq=16, seed=seed, **kw)


def _equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for key in fa:
        assert torch.equal(fa[key], fb[key]), key


def test_accum_for_sub_batch():
    assert accum_for_sub_batch(4, 1) == 4
    assert accum_for_sub_batch(4, 2) == 2
    assert accum_for_sub_batch(5, 2) == 3
    assert accum_for_sub_batch(4, 9) == 1
    with pytest.raises(ValueError):
        accum_for_sub_batch(4, 0)


def test_pair_members_equal_their_solo_steps():
    specs = [_spec("minicpm-2b", accum_steps=2),
             _spec("qwen2-vl-2b", batch=3, seed=1, accum_steps=2)]
    solo = ScheduleExecutor(device=CPU)
    pair = ScheduleExecutor(device=CPU)
    for i, spec in enumerate(specs):
        for ex in (solo, pair):
            ex.submit(f"j{i}", spec, 2)
            ex.start(f"j{i}")
    for _ in range(2):
        res = pair.step_group(["j0", "j1"])
        for name in ("j0", "j1"):
            assert solo.step_group([name])["losses"][name] == \
                res["losses"][name]
    for name in ("j0", "j1"):
        _equal(solo.runs[name].params, pair.runs[name].params)
        _equal(solo.runs[name].opt.m, pair.runs[name].opt.m)
        assert solo.runs[name].opt.step == pair.runs[name].opt.step == 2


def test_reconfig_carries_state_exactly():
    spec = _spec("minicpm-2b")
    ex = ScheduleExecutor(device=CPU)
    ex.submit("a", spec, 3)
    ex.start("a", sub_batch=1)                       # s = 4
    ex.step_group(["a"])
    run = ex.runs["a"]
    params, opt = run.params, run.opt
    before = {k: t.clone() for k, t in flatten(params).items()}
    ex.reconfigure("a", 2)                           # s = 2
    assert run.params is params and run.opt is opt
    _equal(run.params, before)
    assert run.accum_steps == 2 and run.reconfigs == [(1, 2)]
    ex.step_group(["a"])
    ex.reconfigure("a", 3)                           # s = 2, ragged b = 3
    ex.step_group(["a"])

    # the same three steps by hand
    p = init_params(spec.cfg, spec.seed, device=CPU)
    o = adamw_init(p)
    batch = make_batch(spec.cfg, spec.batch, spec.seq, seed=spec.seed,
                       device=CPU)
    for s in (4, 2, 2):
        p, o, _ = make_train_step(spec.cfg, TrainConfig(accum_steps=s))(
            p, o, batch)
    _equal(run.params, p)
    _equal(run.opt.v, o.v)
    report = ex.finish("a").report()
    assert report["steps"] == 3 and report["sub_batch"] == 3
    assert run.params is None and run.opt is None


def test_group_step_is_flat_and_in_place():
    specs = [_spec("minicpm-2b"), _spec("qwen2-vl-2b", seed=1)]
    state = []
    for spec in specs:
        p = init_params(spec.cfg, spec.seed, device=CPU)
        state += [p, adamw_init(p),
                  make_batch(spec.cfg, spec.batch, spec.seq, device=CPU)]
    out = make_group_step(specs)(*state)
    assert len(out) == 6
    assert out[0] is state[0] and out[3] is state[3]
    assert set(out[2]) == {"loss", "grad_norm"}


def test_execute_runs_a_plan():
    ex = ScheduleExecutor(device=CPU)
    ex.submit("a", _spec("minicpm-2b"), 3)
    ex.submit("b", _spec("qwen2-vl-2b", seed=1), 2)
    report = ex.execute([
        PlanPhase(ops=(PlanOp("start", "a", 2), PlanOp("start", "b", 4)),
                  quotas=(("a", 2), ("b", 2)), groups=(("a", "b"),)),
        PlanPhase(ops=(PlanOp("finish", "b"), PlanOp("reconfig", "a", 1)),
                  quotas=(("a", 1),), groups=(("a",),)),
        PlanPhase(ops=(PlanOp("finish", "a"),), quotas=(), groups=()),
    ])
    assert report["a"]["steps"] == 3 and report["b"]["steps"] == 2
    assert report["a"]["accum_steps"] == 4
    assert report["a"]["walltime"] > report["b"]["walltime"] > 0
    with pytest.raises(ValueError):
        ex._apply(PlanOp("pause", "a"))


def test_measurements_return_their_keys():
    a, b = _spec("minicpm-2b", accum_steps=2), _spec("qwen2-vl-2b")
    r = measure_pair(a, b, iters=1, device=CPU)
    assert set(r) == {"t_a_solo", "t_b_solo", "t_pair", "xi_a", "xi_b",
                      "iters"}
    assert r["xi_a"] == r["t_pair"] / r["t_a_solo"] > 0
    assert measure_solo(a, iters=1, device=CPU) > 0
    assert measure_group([a, b], iters=1, device=CPU) > 0


def test_lifecycle_errors():
    ex = ScheduleExecutor(device=CPU)
    ex.submit("a", _spec("minicpm-2b"), 1)
    with pytest.raises(ValueError):
        ex.submit("a", _spec("minicpm-2b"), 1)
    with pytest.raises(RuntimeError):
        ex.step_group(["a"])                 # not started
    ex.start("a")
    with pytest.raises(RuntimeError):
        ex.start("a")
    with pytest.raises(RuntimeError):
        ex.finish("a")                       # 0 of 1 steps
    ex.step_group(["a"])
    ex.finish("a")
    with pytest.raises(RuntimeError):
        ex.reconfigure("a", 2)


def test_entry_points_never_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    spec = _spec("minicpm-2b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScheduleExecutor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(spec.cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_batch(spec.cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_solo(spec, iters=1)
