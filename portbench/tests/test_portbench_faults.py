"""A run with the timed path broken underneath comes out not correct:
the harness is driven whole (bar its look for a card) on a tiny CPU
cell, once sound and once with each fault a training cell can have on
one card: a step that returns its state unchanged, and half the batch
left out with the mean taken over the rest. (The exchange between cards
does not exist on one card; a training cell produces no tokens.)"""
import pytest
import torch

from portbench import harness
from portbench.tests import tiny


def run(root):
    result, code = harness.run_cell(root, "tiny.t", 2 ** 32 + 11, 0.2,
                                    False, device="cpu")
    assert code == 0
    return result


@pytest.mark.parametrize("family,co_tenant", [("dense", "vlm"),
                                              ("hybrid", None)])
def test_sound_run_is_correct(tmp_path, family, co_tenant):
    assert run(tiny.make_root(tmp_path, family, co_tenant))["correct"]


def unchanged_state(specs):
    from repro_torch.train import loss_fn

    def group_step(*state):
        out = []
        for i, spec in enumerate(specs):
            p, o, b = state[3 * i:3 * i + 3]
            with torch.no_grad():
                loss, _ = loss_fn(spec.cfg, p, b)
            out += [p, o, {"loss": loss, "grad_norm": torch.zeros(())}]
        return tuple(out)
    return group_step


@pytest.mark.parametrize("family,co_tenant", [("dense", "vlm"),
                                              ("hybrid", None)])
def test_state_left_unchanged_is_not_correct(tmp_path, monkeypatch, family,
                                             co_tenant):
    from repro_torch.launch import cluster
    monkeypatch.setattr(cluster, "make_group_step", unchanged_state)
    res = run(tiny.make_root(tmp_path, family, co_tenant))
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items()
               if k.endswith("change_gap"))


@pytest.mark.parametrize("family,co_tenant", [("dense", "vlm"),
                                              ("hybrid", None)])
def test_half_the_batch_is_not_correct(tmp_path, monkeypatch, family,
                                       co_tenant):
    from repro_torch.train import train_step
    whole = train_step.accumulate_gradients

    def half(lg, params, batch, accum_steps, **kw):
        rows = next(iter(batch.values())).shape[0] // 2
        return whole(lg, params, {k: t[:rows] for k, t in batch.items()},
                     max(1, accum_steps // 2), **kw)
    monkeypatch.setattr(train_step, "accumulate_gradients", half)
    res = run(tiny.make_root(tmp_path, family, co_tenant))
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items()
               if k.endswith("grad_gap"))
