"""The port's spans (``repro_torch.util.spans``) on the CPU: the tree one
group step opens under ``torch.profiler``, the shared no-op without a
profiler, the same bits with the profiler on and off, the garbage
collector's span, and one span a kernel call on the DTensor path."""
import dataclasses
import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
from repro_torch.tree import flatten
from repro_torch.util import spans
from _torch_threads import one_torch_thread  # noqa: F401

P = "repro_torch."


def _executor(arch, seed=0):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    ex = ScheduleExecutor(device="cpu")
    ex.submit("a", JobSpec(cfg, batch=4, seq=16, seed=seed, accum_steps=2),
              3)
    ex.start("a")
    return cfg, ex


def _spans(prof):
    """{name: [(start, end)]} of the port's spans in a finished profile."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(P):
            out.setdefault(e.name()[len(P):], []).append(
                (e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer):
    return [i for i in inner if any(s <= i[0] and i[1] <= e
                                    for s, e in outer)]


@pytest.mark.parametrize("arch", ["minicpm-2b", "zamba2-7b"])
def test_one_group_step_opens_the_span_tree(arch):
    cfg, ex = _executor(arch)
    assert cfg.n_units >= 1 and ex.runs["a"].accum_steps == 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.step_group(["a"])
    got = _spans(prof)
    group = got["executor.step_group"]
    assert len(group) == 1
    assert len(got["step.micro_batch"]) == 2
    for mb in got["step.micro_batch"]:
        for phase in ("forward", "backward", "accumulate"):
            assert len(_inside(got[f"step.{phase}"], [mb])) == 1, phase
    # the accumulator's zero and its 1/s scale, outside the micro-batches
    assert len(got["step.accumulate"]) == 4
    assert len(got["step.optimizer"]) == 1
    assert not _inside(got["step.optimizer"], got["step.micro_batch"])
    # each unit twice a micro-batch: in the forward and in the recompute
    units = got["model.unit"]
    assert len(units) == 2 * 2 * cfg.n_units
    assert len(_inside(units, got["step.forward"])) == 2 * cfg.n_units
    assert len(_inside(units, got["step.backward"])) == 2 * cfg.n_units
    calls = {"dense": {"kernels.attention": 4 * cfg.n_units,
                       "kernels.attention_bwd": 2 * cfg.n_units},
             "hybrid": {"kernels.attention": 4 * cfg.n_units,
                        "kernels.attention_bwd": 2 * cfg.n_units,
                        "kernels.ssd": 4 * cfg.n_layers,
                        "kernels.ssd_bwd": 2 * cfg.n_layers}}[cfg.family]
    assert {k for k in got if k.startswith("kernels.")} == set(calls)
    for name, n in calls.items():
        assert len(got[name]) == n, name
        # a call's forward inside its unit, its backward after the
        # unit's recompute
        inside = 0 if name.endswith("_bwd") else n
        assert len(_inside(got[name], units)) == inside, name
    for name, rows in got.items():
        if name != "gc":
            assert len(_inside(rows, group)) == len(rows), name


def test_without_a_profiler_span_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a RecordFunction for {name} was opened")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("repro_torch.x") is spans.NO_SPAN
    with spans.span("repro_torch.x"):
        pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(spans.span("repro_torch.x"),
                          torch.autograd.profiler.record_function)


def _three_steps(arch, profiled):
    _, ex = _executor(arch, seed=3)
    losses = []
    for _ in range(3):
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                losses.append(ex.step_group(["a"])["losses"]["a"])
        else:
            losses.append(ex.step_group(["a"])["losses"]["a"])
    return losses, flatten(ex.runs["a"].params)


@pytest.mark.parametrize("arch", ["minicpm-2b", "zamba2-7b"])
def test_the_profiler_leaves_every_bit(arch):
    l0, p0 = _three_steps(arch, False)
    l1, p1 = _three_steps(arch, True)
    assert l0 == l1
    assert sorted(p0) == sorted(p1)
    for key in p0:
        assert torch.equal(p0[key], p1[key]), key


def test_a_collection_opens_a_gc_span_only_while_profiled():
    spans.install_gc_spans()
    spans.install_gc_spans()
    assert gc.callbacks.count(spans._gc_span) == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    assert len(_spans(prof).get("gc", [])) >= 1
    assert not spans._open_gc
    gc.collect()
    assert not spans._open_gc
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2).sum()
    assert "gc" not in _spans(prof)


@pytest.mark.parametrize("call", ["attention", "ssd"])
def test_one_span_a_call_on_the_dtensor_path(monkeypatch, call):
    # the local blocks re-enter the wrapper below its span
    entered = []

    def local(fn, args, *roles):
        entered.append(fn)
        return fn(*args)
    calls = iter([True])
    monkeypatch.setattr(ops, "is_dtensor", lambda t: next(calls, False))
    monkeypatch.setattr(ops, "on_local_blocks", local)
    g = torch.Generator().manual_seed(0)
    if call == "attention":
        args = [torch.randn(1, 64, 2, 64, generator=g) for _ in range(3)]
        fn = ops.flash_attention
    else:
        args = [torch.randn(1, 64, 2, 64, generator=g),
                torch.rand(1, 64, 2, generator=g),
                -torch.rand(2, generator=g),
                torch.randn(1, 64, 16, generator=g),
                torch.randn(1, 64, 16, generator=g)]
        fn = ops.ssd
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    assert len(entered) == 1
    assert len(_spans(prof)[f"kernels.{call}"]) == 1
