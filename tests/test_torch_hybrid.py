"""The port's hybrid family (zamba2-7b) against the reference at reduced
size, in f32: the weight bridge, the Mamba2 block, the logits, one train
step, and gradient accumulation and the executor inside the port.

The reduced config is the reference's ``reduced()``: 9 layers = one unit
of nine Mamba2 layers and the shared attention block, d_model 256, 4 SSM
heads of P = 128, N = 16. The 2-unit variant (18 layers) applies the
shared block twice, so its gradient sums over two applications.

Tolerances, after dividing by max(1, max|reference|): logits and the
block's output 1e-4 (``test_torch_model.py``'s, the same f32 arithmetic in
another order through a few layers); the train step as
``test_torch_train.py`` holds it (loss 1e-5 relative, moments 1e-5,
params 1e-6 against the reference's AdamW on the port's gradients);
accumulated == full batch at ``test_grad_accum.py``'s rtol 5e-4 /
atol 5e-6."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.npz import _flatten
from repro.configs import get_config as jax_config
from repro.data import make_batch as jax_batch
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init
from repro.models.ssm import mamba2_forward as jax_mamba2_forward
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import adamw_init as jax_adamw_init
from repro.train import adamw_update as jax_adamw_update
from repro.train import make_train_step as jax_train_step
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.core.coschedule import measure_pair
from repro_torch.data import make_batch
from repro_torch.kernels import ssd
from repro_torch.launch.cluster import JobSpec, ScheduleExecutor
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import (forward, init_cache, init_params,
                                prefill_extend)
from repro_torch.models.ssm import mamba2_forward
from repro_torch.train import (TrainConfig, accumulate_gradients,
                               adamw_init, make_loss_and_grad,
                               make_train_step)
from repro_torch.tree import flatten, grad_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401

UNITS = [9, 18]                # n_layers: one unit, two units
F32_LEAVES = ("A_log", "dt_bias", "D")


def _configs(n_layers, dtype="float32"):
    jc = dataclasses.replace(jax_config("zamba2-7b").reduced(), dtype=dtype,
                             n_layers=n_layers)
    tc = dataclasses.replace(get_config("zamba2-7b").reduced(), dtype=dtype,
                             n_layers=n_layers)
    return jc, tc


def _close(got, want, tol, err_msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               rtol=tol, err_msg=err_msg)


def _bridged(n_layers, seed=0):
    jc, tc = _configs(n_layers)
    jp = jax_init(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(_flatten(jp), device="cpu")


def test_reduced_config_is_the_reference_reduced():
    _, tc = _configs(9)
    assert (tc.n_units, tc.pattern_unit(), tc.d_model, tc.n_ssm_heads,
            tc.d_inner // tc.n_ssm_heads, tc.ssm_state) == (
        1, 9, 256, 4, 128, 16)


@pytest.mark.parametrize("n_layers", UNITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_matches_reference(n_layers, dtype):
    jc, tc = _configs(n_layers, dtype)
    jp = jax_init(jc, jax.random.PRNGKey(0))
    params = init_params(tc, 0, device="cpu")
    want = {k: (v.shape, str(v.dtype)) for k, v in _flatten(jp).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten(params).items()}
    assert got == want
    assert flatten(params)["units/mamba/mamba/in_proj/w"].shape[:2] == (
        tc.n_units, 9)


def test_bridge_keeps_the_f32_leaves_of_a_bf16_model():
    jc, _ = _configs(9, "bfloat16")
    flat = _flatten(jax_init(jc, jax.random.PRNGKey(1)))
    params = flatten(params_from_numpy(flat, device="cpu"))
    for key, t in params.items():
        f32 = key.rsplit("/", 1)[-1] in F32_LEAVES
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), key
    back = params_to_numpy(params_from_numpy(flat, device="cpu"))
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key],
                                      np.asarray(arr, dtype=np.float32))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("seq", [48, 200])
def test_mamba2_block_matches_reference(use_kernel, seq):
    jc, tc, jp, params = _bridged(9)
    i = 4                                       # a middle layer
    jl = jax.tree.map(lambda t: t[0, i], jp["units"]["mamba"]["mamba"])
    tl = tree_map(lambda t: t[0, i], params["units"]["mamba"]["mamba"])
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, tc.d_model), dtype=np.float32)
    kw = dict(d_inner=tc.d_inner, ssm_state=tc.ssm_state,
              n_heads=tc.n_ssm_heads)
    want = jax_mamba2_forward(jl, jax.numpy.asarray(x),
                              use_kernel=use_kernel, **kw)
    got = mamba2_forward(tl, torch.from_numpy(x), **kw)
    _close(got.detach(), np.asarray(want), 1e-4)


@pytest.mark.parametrize("n_layers", UNITS)
@pytest.mark.parametrize("seq", [48, 200])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_logits_match_reference(n_layers, seq, use_kernels):
    """The reference with and without its Pallas SSD (interpret mode);
    seq 200 spans four of the port's chunks and pads the last."""
    jc, tc, jp, params = _bridged(n_layers)
    jb = jax_batch(jc, 2, seq, seed=3)
    tb = make_batch(tc, 2, seq, seed=3, device="cpu")
    want, _ = jax_forward(jc, jp, jb, use_kernels=use_kernels)
    got, aux = forward(tc, params, tb)
    assert got.shape == want.shape
    _close(got.detach(), np.asarray(want), 1e-4)
    assert float(aux) == 0.0


def _jax_tree(flat: dict, like):
    paths, treedef = jax.tree_util.tree_flatten_with_path(like)
    keys = ["/".join(str(p.key) for p in path) for path, _ in paths]
    return treedef.unflatten([jax.numpy.asarray(flat[k]) for k in keys])


@pytest.mark.parametrize("n_layers", UNITS)
@pytest.mark.parametrize("batch,accum", [(4, 1), (5, 3)])
def test_train_step_matches_reference(n_layers, batch, accum):
    jc, tc, jp, params = _bridged(n_layers)
    jb = jax_batch(jc, batch, 32)
    tb = make_batch(tc, batch, 32, device="cpu")
    jtc = JaxTrainConfig(accum_steps=accum)
    _, jo2, jm = jax_train_step(jc, jtc)(jp, jax_adamw_init(jp), jb)
    tcfg = TrainConfig(accum_steps=accum)
    _, grads = accumulate_gradients(make_loss_and_grad(tc, tcfg), params,
                                    tb, accum)
    grads = params_to_numpy(grads)
    opt = adamw_init(params)
    p2, o2, m = make_train_step(tc, tcfg)(params, opt, tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for got, want in ((o2.m, jo2.m), (o2.v, jo2.v)):
        got, want = params_to_numpy(got), _flatten(want)
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], 1e-5, key)
    want, _ = jax_adamw_update(_jax_tree(grads, jp), jax_adamw_init(jp), jp,
                               lr=jtc.lr, weight_decay=jtc.weight_decay)
    got = params_to_numpy(p2)
    for key, w in _flatten(want).items():
        _close(got[key], w, 1e-6, key)
    for key, t in flatten(p2).items():
        if key.rsplit("/", 1)[-1] in F32_LEAVES:
            assert t.dtype == torch.float32


@pytest.mark.parametrize("n_layers", UNITS)
@pytest.mark.parametrize("batch,accum", [(8, 2), (5, 3), (6, 4)])
def test_accumulated_equals_full_batch(n_layers, batch, accum):
    _, tc = _configs(n_layers)
    params = init_params(tc, 0, device="cpu")
    data = make_batch(tc, batch, 24, device="cpu")
    lg = make_loss_and_grad(tc, TrainConfig())
    loss_full, g_full = accumulate_gradients(lg, params, data, 1)
    loss_acc, g_acc = accumulate_gradients(lg, params, data, accum)
    torch.testing.assert_close(loss_acc, loss_full, rtol=1e-5, atol=1e-6)
    fa, ff = flatten(g_acc), flatten(g_full)
    assert sorted(fa) == sorted(flatten(params))
    for key in ff:
        assert fa[key].dtype == torch.float32
        torch.testing.assert_close(fa[key], ff[key], rtol=5e-4, atol=5e-6)


def test_gradients_come_one_leaf_per_unit_and_layer():
    _, tc = _configs(18)
    params = init_params(tc, 0, device="cpu")
    split, slots = grad_leaves(params, ("mamba",))
    assert len(split["units"]) == 2
    assert len(split["units"][0]["mamba"]) == 9
    in_proj = [(idx, leaf.shape) for key, idx, leaf in slots
               if key == "units/mamba/mamba/in_proj/w"]
    assert [idx for idx, _ in in_proj] == [(u, i) for u in range(2)
                                           for i in range(9)]
    assert {shape for _, shape in in_proj} == {
        flatten(params)["units/mamba/mamba/in_proj/w"].shape[2:]}
    _, grads = make_loss_and_grad(tc)(params,
                                      make_batch(tc, 2, 16, device="cpu"))
    assert [(key, idx, g.shape) for key, idx, g in grads] == [
        (key, idx, leaf.shape) for key, idx, leaf in slots]
    shared = [idx for key, idx, _ in grads
              if key == "shared_attn/attn/wq/w"]
    assert shared == [None]


def test_executor_runs_a_hybrid_job():
    """Start, a reconfig, a ragged step and finish, and ``measure_pair``
    with a dense job: the executor needs nothing new for a hybrid."""
    _, tc = _configs(9)
    spec = JobSpec(tc, batch=4, seq=16, seed=0)
    ex = ScheduleExecutor(device="cpu")
    ex.submit("z", spec, 3)
    ex.start("z", sub_batch=1)                          # s = 4
    ssd.reset_launches()
    losses = [ex.step_group(["z"])["losses"]["z"]]
    ex.reconfigure("z", 2)                              # s = 2
    losses.append(ex.step_group(["z"])["losses"]["z"])
    run = ex.runs["z"]
    assert run.accum_steps == 2 and run.reconfigs == [(1, 2)]
    state = (run.params, run.opt, make_batch(tc, 5, 16, device="cpu"))
    ex.reconfigure("z", 4)
    losses.append(ex.step_group(["z"])["losses"]["z"])
    ex.finish("z")
    ragged = ScheduleExecutor(device="cpu")
    ragged.submit("r", JobSpec(tc, batch=5, seq=16), 1)
    ragged.start("r", sub_batch=2, state=state)         # s = 3
    losses.append(ragged.step_group(["r"])["losses"]["r"])
    assert ragged.runs["r"].accum_steps == 3
    assert all(np.isfinite(losses))
    assert ssd.LAUNCHES == {"ssd_fwd": 0, "ssd_bwd": 0}
    qwen = dataclasses.replace(get_config("qwen2-vl-2b").reduced(),
                               dtype="float32")
    r = measure_pair(JobSpec(tc, batch=4, accum_steps=2, seq=16),
                     JobSpec(qwen, batch=4, seq=16, seed=1), iters=1,
                     device="cpu")
    assert r["xi_a"] == r["t_pair"] / r["t_a_solo"] > 0


def test_serving_a_hybrid_names_its_slice():
    """The hybrid serves (``test_torch_hybrid_serve.py``); what stays
    refused is what the reference refuses: a suffix prefill, which would
    need the recurrent state at the prefix's end, and prefix sharing,
    which rests on it."""
    _, tc = _configs(9)
    params = init_params(tc, 0, device="cpu")
    cache = init_cache(tc, 2, 64, device="cpu")
    with pytest.raises(ValueError, match="recurrent state"):
        prefill_extend(tc, params, cache,
                       torch.zeros((2, 4), dtype=torch.long), start=8)
    with pytest.raises(ValueError, match="recurrent state"):
        DecodeEngine(tc, params, n_slots=2, max_len=64, paged=True,
                     prefix_share=True)
    DecodeEngine(tc, params, n_slots=2, max_len=64, paged=True)
