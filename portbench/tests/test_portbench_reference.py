"""The plain reference against a tiny CPU run of the port: the loss and
every gradient of one batch, and three training steps through the
harness, in float32, where the two differ by rounding alone."""
import pytest
import torch

from portbench import data, harness, program
from portbench.families import dense, hybrid
from portbench.reference import train as reference
from portbench.tests import tiny

FAMILIES = {"dense": dense, "vlm": dense, "hybrid": hybrid}


@pytest.mark.parametrize("family", ["dense", "vlm", "hybrid"])
def test_loss_and_gradients_match_the_port(family):
    from repro_torch.train import loss_fn
    run = tiny.config(family, "float32")["run"]
    cfg = program.port_config(run)
    weights = data.make_weights(program.layout(cfg), 7, "cpu")
    batch = data.make_batches(run, 3, 128, 1, 8, "cpu")[0]
    tree = program.unflatten({k: t.clone().requires_grad_(True)
                              for k, t in weights.items()})
    loss, _ = loss_fn(cfg, tree, batch, remat=False)
    flat = program._flat(tree)
    port_grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    layered = FAMILIES[family].LAYERED
    P = {k: t.float().clone().requires_grad_(True)
         for k, t in reference.leaves(weights, layered).items()}
    from portbench.reference import dense as ref_dense, hybrid as ref_hybrid
    model = ref_hybrid if family == "hybrid" else ref_dense
    losses = [model.row_loss(P, run, {k: t[r] for k, t in batch.items()},
                             "f32") for r in range(3)]
    ref_loss = sum(losses) / 3
    assert float(ref_loss.detach()) == pytest.approx(float(loss.detach()),
                                                     rel=1e-5)
    ref_grads = dict(zip(P, torch.autograd.grad(ref_loss, list(P.values()))))
    want = reference.leaves(port_grads, layered)
    assert set(want) == set(ref_grads)
    for k, g in ref_grads.items():
        scale = float(want[k].abs().max()) + 1e-12
        assert float((g - want[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("family,co_tenant", [("dense", "vlm"),
                                              ("hybrid", None)])
def test_three_f32_steps_through_the_harness(tmp_path, family, co_tenant):
    root = tiny.make_root(tmp_path, family, co_tenant, dtype="float32")
    result, code = harness.run_cell(root, "tiny.t", 2 ** 33 + 5, 0.2, False,
                                    device="cpu")
    assert code == 0 and result["correct"]
    for key, c in result["checks"].items():
        bound = 1e-4 if key.endswith("loss_gap") else 2e-3
        assert c["value"] <= bound, (key, c)
