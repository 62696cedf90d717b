"""One train step of the port against the reference, and the paper's
gradient-accumulation identity inside the port.

Against the reference (f32, reduced config, same weights and batch):
loss to 1e-5 relative; AdamW moments to 1e-5 after dividing by
max(1, max|reference|). Params two ways, neither of which a port that
left its params alone could pass:

- the port's params equal the reference's ``adamw_update`` (with the
  reference ``TrainConfig``'s lr and weight decay) applied to the port's
  own gradients, to 1e-6 after the same scaling: the same f32 arithmetic
  on the same inputs, up to the last ulp;
- the port's update ``p1 - p0`` equals the reference's to 1e-6 absolute
  (lr / 300) on every entry whose gradient exceeds 1e-4. The first AdamW
  step divides each gradient by its own magnitude plus eps = 1e-8, so an
  entry with a gradient near eps turns the frameworks' last-ulp gradient
  differences into movement of the order of lr; above 1e-4 that
  sensitivity is below 1e-4 of lr.

Inside the port, accumulated == full batch to ``test_grad_accum.py``'s
rtol 5e-4 / atol 5e-6 on gradients and rtol 1e-5 / atol 1e-6 on loss."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.npz import _flatten
from repro.configs import get_config as jax_config
from repro.data import make_batch as jax_batch
from repro.models import init_params as jax_init
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import adamw_init as jax_adamw_init
from repro.train import adamw_update as jax_adamw_update
from repro.train import cosine_schedule as jax_cosine
from repro.train import make_train_step as jax_train_step
from repro.train import wsd_schedule as jax_wsd
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.models import init_params
from repro_torch.train import (TrainConfig, accumulate_gradients,
                               adamw_init, cosine_schedule,
                               make_loss_and_grad, make_train_step,
                               wsd_schedule)
from repro_torch.tree import flatten
from _torch_threads import one_torch_thread  # noqa: F401


def _configs(name):
    jc = dataclasses.replace(jax_config(name).reduced(), dtype="float32")
    tc = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    return jc, tc


def _jax_tree(flat: dict, like):
    """A flat dict under the npz keys as a tree shaped like ``like``."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    keys = ["/".join(str(p.key) if isinstance(p, jax.tree_util.DictKey)
                     else str(getattr(p, "idx", p)) for p in path)
            for path, _ in paths]
    return treedef.unflatten([jax.numpy.asarray(flat[k]) for k in keys])


def _close(got: dict, want: dict, tol: float):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[key] / scale, w / scale, atol=tol,
                                   rtol=tol, err_msg=key)


@pytest.mark.parametrize("name", ["minicpm-2b", "qwen2-vl-2b"])
@pytest.mark.parametrize("batch,accum", [(4, 1), (4, 2), (5, 3)])
def test_train_step_matches_reference(name, batch, accum):
    jc, tc = _configs(name)
    jp = jax_init(jc, jax.random.PRNGKey(0))
    params = params_from_numpy(_flatten(jp), device="cpu")
    jb = jax_batch(jc, batch, 32)
    tb = make_batch(tc, batch, 32, device="cpu")

    jtc = JaxTrainConfig(accum_steps=accum)
    jp2, jo2, jm = jax_train_step(jc, jtc)(jp, jax_adamw_init(jp), jb)
    tcfg = TrainConfig(accum_steps=accum)
    _, grads = accumulate_gradients(make_loss_and_grad(tc, tcfg), params,
                                    tb, accum)
    grads = params_to_numpy(grads)
    opt = adamw_init(params)
    p2, o2, m = make_train_step(tc, tcfg)(params, opt, tb)

    assert p2 is params and o2 is opt and o2.step == int(jo2.step) == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    _close(params_to_numpy(o2.m), _flatten(jo2.m), 1e-5)
    _close(params_to_numpy(o2.v), _flatten(jo2.v), 1e-5)
    got = params_to_numpy(p2)
    # the port's step is the reference's AdamW on the port's gradients
    want, _ = jax_adamw_update(_jax_tree(grads, jp), jax_adamw_init(jp), jp,
                               lr=jtc.lr, weight_decay=jtc.weight_decay)
    _close(got, _flatten(want), 1e-6)
    # and its update is the reference's wherever the gradient is not
    # near eps
    p0, p_ref, g_ref = _flatten(jp), _flatten(jp2), _flatten(jo2.m)
    checked = 0
    for key, p in p0.items():
        g = np.asarray(g_ref[key]) / (1 - 0.9)       # m_1 = (1 - b1) g
        big = np.abs(g) > 1e-4
        checked += int(big.sum())
        np.testing.assert_allclose((got[key] - p)[big],
                                   (np.asarray(p_ref[key]) - p)[big],
                                   rtol=0, atol=1e-6, err_msg=key)
    # most entries: 86 % at the reduced minicpm-2b config
    assert checked > 0.5 * sum(p.size for p in p0.values())


@pytest.mark.parametrize("name", ["minicpm-2b", "qwen2-vl-2b"])
@pytest.mark.parametrize("batch,accum", [(8, 2), (8, 4), (7, 4), (6, 4),
                                         (5, 3)])
def test_accumulated_equals_full_batch(name, batch, accum):
    _, tc = _configs(name)
    params = init_params(tc, 0, device="cpu")
    data = make_batch(tc, batch, 32, device="cpu")
    lg = make_loss_and_grad(tc, TrainConfig())
    loss_full, g_full = accumulate_gradients(lg, params, data, 1)
    loss_acc, g_acc = accumulate_gradients(lg, params, data, accum)
    torch.testing.assert_close(loss_acc, loss_full, rtol=1e-5, atol=1e-6)
    fa, ff = flatten(g_acc), flatten(g_full)
    assert sorted(fa) == sorted(flatten(params))
    for key in ff:
        assert fa[key].dtype == torch.float32
        torch.testing.assert_close(fa[key], ff[key], rtol=5e-4, atol=5e-6)


def test_premasked_batch_is_refused_when_accumulating():
    _, tc = _configs("minicpm-2b")
    params = init_params(tc, 0, device="cpu")
    data = make_batch(tc, 4, 16, device="cpu")
    data["sample_mask"] = torch.ones(4)
    lg = make_loss_and_grad(tc, TrainConfig())
    with pytest.raises(ValueError, match="sample_mask"):
        accumulate_gradients(lg, params, data, 2)
    loss, _ = accumulate_gradients(lg, params, data, 1)
    assert torch.isfinite(loss)


def test_schedules_match_reference():
    import jax.numpy as jnp
    kw = dict(peak_lr=1e-3, warmup_steps=5, stable_steps=10, decay_steps=8,
              floor=1e-5)
    ckw = dict(peak_lr=1e-3, warmup_steps=5, total_steps=30)
    for step in [0, 1, 4, 5, 9, 15, 18, 23, 40]:
        s = jnp.asarray(step, jnp.int32)
        np.testing.assert_allclose(wsd_schedule(**kw)(step),
                                   float(jax_wsd(**kw)(s)), rtol=1e-6)
        np.testing.assert_allclose(cosine_schedule(**ckw)(step),
                                   float(jax_cosine(**ckw)(s)), rtol=1e-6)
