"""The five architectures this slice ports (glm4-9b, stablelm-12b,
llama3-405b, granite-moe-3b-a800m, llama4-maverick-400b-a17b) against
the reference: full parameter counts (on ``meta``, against the
reference's ``jax.eval_shape``), the reduced layout, and at reduced size
the forward logits, loss, aux loss and gradients, with the reference's
weights carried across by ``checkpoint.bridge`` and batches from one
numpy seed; dense serving (prefill and decode) for the three dense
configs; and head_dim 160 (stablelm-12b's, which its reduced config
does not keep) through the model and through the plain versions of the
flash forward, dQ, dK/dV and decode against the reference's Pallas
kernels in interpret mode.

Tolerances, after dividing by max(1, max|reference|): f32 logits 1e-4
(``test_torch_model.py``'s: a few layers and a vocab-wide head in
another order), f32 loss, aux and gradients 1e-5, one kernel 1e-5
(``test_torch_flash_attention.py``'s); bf16 losses 2**-9 relative (the
same bf16 weights and inputs, rounded at other places in the two
frameworks through two layers)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.npz import _flatten
from repro.configs import get_config as jax_config
from repro.data import make_batch as jax_batch
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_decode import flash_decode as jax_decode
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import param_count as jax_param_count
from repro.models import prefill as jax_prefill
from repro.train.train_step import loss_fn as jax_loss_fn
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, param_count, prefill)
from repro_torch.train import (TrainConfig, accumulate_gradients,
                               make_loss_and_grad)
from repro_torch.train.train_step import loss_fn
from repro_torch.tree import flatten
from _torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ["glm4-9b", "stablelm-12b", "llama3-405b",
            "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]
DENSE = FAMILIES[:3]
# the reference's parameter counts, in billions to 3 places
PUBLISHED = {"glm4-9b": 9.400, "stablelm-12b": 12.143,
             "llama3-405b": 405.853, "granite-moe-3b-a800m": 3.374,
             "llama4-maverick-400b-a17b": 400.712}
LOGIT_TOL, TOL, BF16_LOSS_TOL = 1e-4, 1e-5, 2 ** -9


def _close(got, want, tol=TOL, err_msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol,
                               err_msg=err_msg)


def _configs(name, dtype="float32", **kw):
    jc = dataclasses.replace(jax_config(name).reduced(), dtype=dtype, **kw)
    tc = dataclasses.replace(get_config(name).reduced(), dtype=dtype, **kw)
    return jc, tc


@pytest.mark.parametrize("name", FAMILIES)
def test_full_parameter_counts_match_reference(name):
    """At full size, on ``meta`` (shapes only): the port's count equals
    the reference's from ``jax.eval_shape``, and the published size."""
    got = param_count(init_params(get_config(name), 0, device="meta"))
    shapes = jax.eval_shape(lambda: jax_init(jax_config(name),
                                             jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert got == want
    assert round(got / 1e9, 3) == PUBLISHED[name]


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_matches_reference(name, dtype):
    jc, tc = _configs(name, dtype)
    jp = jax_init(jc, jax.random.PRNGKey(0))
    params = init_params(tc, 0, device="cpu")
    want = {k: (v.shape, str(v.dtype)) for k, v in _flatten(jp).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten(params).items()}
    assert got == want
    assert param_count(params) == jax_param_count(jp)


def _bridged(name, dtype="float32", seed=0, **kw):
    jc, tc = _configs(name, dtype, **kw)
    jp = jax_init(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(_flatten(jp), device="cpu")


def _jax_tokens(tb):
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_logits_loss_aux_and_gradients_match_reference(name):
    jc, tc, jp, tp = _bridged(name)
    tb = make_batch(tc, 2, 32, seed=3, device="cpu")
    jb = jax_batch(jc, 2, 32, seed=3)
    for key in jb:
        np.testing.assert_array_equal(np.asarray(jb[key]), tb[key].numpy())
    want_logits, want_aux = jax_forward(jc, jp, jb)
    got_logits, got_aux = forward(tc, tp, tb)
    _close(got_logits.detach().numpy(), want_logits, LOGIT_TOL)
    _close(float(got_aux), float(want_aux))
    if tc.family == "moe":
        assert float(got_aux) > 0

    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: jax_loss_fn(jc, p, jb), has_aux=True)(jp)
    loss, grads = accumulate_gradients(make_loss_and_grad(tc, TrainConfig()),
                                       tp, tb, 1)
    _close(float(loss), float(want_loss))
    got, want = params_to_numpy(grads), _flatten(want_grads)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_loss_matches_reference(name):
    jc, tc, jp, tp = _bridged(name, "bfloat16", seed=1)
    tb = make_batch(tc, 2, 32, seed=4, device="cpu")
    want, _ = jax_loss_fn(jc, jp, _jax_tokens(tb))
    with torch.no_grad():
        got, _ = loss_fn(tc, tp, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=BF16_LOSS_TOL)


@pytest.mark.parametrize("name", DENSE)
def test_dense_serving_matches_reference(name):
    """Prefill logits and cache, then teacher-forced decode: glm4-9b
    (qkv bias, 2 kv heads), stablelm-12b, llama3-405b (rope_theta 5e5)."""
    jc, tc, jp, tp = _bridged(name)
    prompt = np.random.default_rng(2).integers(0, tc.vocab, (2, 11))
    want, jcache = jax_prefill(jc, jp, jax_init_cache(jc, 2, 24),
                               jnp.asarray(prompt, jnp.int32))
    got, cache = prefill(tc, tp, init_cache(tc, 2, 24, device="cpu"),
                         torch.as_tensor(prompt))
    _close(got.numpy(), want, LOGIT_TOL)
    for key in ("k", "v"):
        _close(cache["units"][key].numpy(), jcache["units"][key], LOGIT_TOL)
    toks = np.random.default_rng(3).integers(0, tc.vocab, (2, 6))
    for t in range(6):
        want, jcache = jax_decode_step(jc, jp, jcache, jnp.asarray(
            toks[:, t:t + 1], jnp.int32))
        got, cache = decode_step(tc, tp, cache,
                                 torch.as_tensor(toks[:, t:t + 1]))
        _close(got.numpy(), want, LOGIT_TOL)


# -- head_dim 160 ------------------------------------------------------- #
def test_head_dim_160_model_matches_reference():
    """stablelm-12b's head_dim 160 on its reduced config (which keeps 64):
    logits, loss and gradients through the plain attention path of both
    packages."""
    jc, tc, jp, tp = _bridged("stablelm-12b", head_dim=160)
    assert flatten(tp)["units/attn/wq/w"].shape[-1] == tc.n_heads * 160
    tb = make_batch(tc, 2, 24, seed=5, device="cpu")
    jb = jax_batch(jc, 2, 24, seed=5)
    want, _ = jax_forward(jc, jp, jb)
    got, _ = forward(tc, tp, tb)
    _close(got.detach().numpy(), want, LOGIT_TOL)
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: jax_loss_fn(jc, p, jb), has_aux=True)(jp)
    loss, grads = accumulate_gradients(make_loss_and_grad(tc, TrainConfig()),
                                       tp, tb, 1)
    _close(float(loss), float(want_loss))
    got = params_to_numpy(grads)
    for key, g in _flatten(want_grads).items():
        _close(got[key], g, err_msg=key)


@pytest.mark.parametrize("case", [dict(causal=True, window=0),
                                  dict(causal=False, window=0),
                                  dict(causal=True, window=48)])
def test_flash_plain_versions_at_head_dim_160_match_reference(case):
    """The forward, dQ and dK/dV plain versions (through the port's
    ``autograd.Function``) against the reference's Pallas kernel in
    interpret mode and its ``jax.grad``, at head_dim 160."""
    rng = np.random.default_rng(16)
    q, k, v, w = (rng.standard_normal((1, 2, 128, 160), dtype=np.float32)
                  for _ in range(4))
    o_j = jax_flash(*map(jnp.asarray, (q, k, v)), interpret=True, **case)
    g_j = jax.grad(lambda q, k, v: jnp.sum(jax_flash(
        q, k, v, interpret=True, **case) * jnp.asarray(w)), (0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o_t = fa.flash_attention(*leaves, **case)
    g_t = torch.autograd.grad((o_t * torch.from_numpy(w)).sum(), leaves)
    _close(o_t.detach().numpy(), o_j)
    for got, want in zip(g_t, g_j):
        _close(got.numpy(), want)


@pytest.mark.parametrize("h,h_kv", [(4, 4), (8, 2)])
def test_decode_plain_version_at_head_dim_160_matches_reference(h, h_kv):
    """``ops.flash_decode`` (its plain version on the CPU) against the
    reference's Pallas decode in interpret mode, which takes the kv heads
    repeated and q as (B, H, 1, D)."""
    rng = np.random.default_rng(h)
    b, s, d = 3, 200, 160
    q = rng.standard_normal((b, 1, h, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, h_kv, d), dtype=np.float32)
            for _ in range(2))
    lengths = np.array([200, 77, 1], np.int32)
    g = h // h_kv
    want = jax_decode(jnp.asarray(q.transpose(0, 2, 1, 3)),
                      jnp.asarray(np.repeat(k, g, 2).transpose(0, 2, 1, 3)),
                      jnp.asarray(np.repeat(v, g, 2).transpose(0, 2, 1, 3)),
                      jnp.asarray(lengths), interpret=True)
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(lengths))
    _close(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3))


def test_head_dims_the_kernels_take():
    """160 is among the head dims both wrappers take; the models of the
    port that attend need no other (xlstm-1.3b, the ssm family, runs no
    attention: its head_dim field, 512, sizes no kernel call)."""
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.kernels import flash_decode as fd
    assert fa.HEAD_DIMS == fd.HEAD_DIMS == (64, 112, 128, 160)
    for name in ARCH_NAMES:
        if get_config(name).family != "ssm":
            assert get_config(name).head_dim in fa.HEAD_DIMS, name
