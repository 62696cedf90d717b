"""The port's MoE FFN (``models/moe.py``) and the moe family against the
reference at reduced size, in f32, with the reference's weights carried
across by ``checkpoint.bridge``.

``moe_forward`` is held to the reference's under all three dispatches
(einsum, scatter, dense), at top_k 1 and 2, with padded experts, a
capacity that drops tokens and the shared expert: outputs and the aux
loss, and their gradients against ``jax.grad``. Then twins of the
reference's ``tests/test_moe.py``, accumulation (the twin of
``tests/test_grad_accum.py``'s ``test_moe_grads_match``), and MoE
serving (prefill, the suffix prefill under the dense dispatch, decode)
against the reference's, with the engines' token identities inside the
port.

Tolerances, after dividing by max(1, max|reference|): 1e-5 for one MoE
layer (the same f32 arithmetic summed in another order); logits 1e-4
through a model, as ``test_torch_model.py`` holds them; accumulation at
the reference's own rtol 1e-3 / atol 1e-5. Routing itself is discrete:
both packages pick the same experts, in ``jax.lax.top_k``'s order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.checkpoint.npz import _flatten
from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import moe as jax_moe
from repro.models import prefill as jax_prefill
from repro.models import prefill_extend as jax_prefill_extend
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import (decode_step, init_cache, init_params,
                                prefill, prefill_extend)
from repro_torch.models import moe
from repro_torch.train import (TrainConfig, accumulate_gradients,
                               make_loss_and_grad)
from repro_torch.tree import flatten
from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
LOGIT_TOL = 1e-4
MOE_MODELS = ["granite-moe-3b-a800m", "llama4-maverick-400b-a17b"]
# (n_experts, pad_to, shared expert, capacity factor)
VARIANTS = {"plain": (4, 0, False, 1.25),
            "padded": (3, 8, False, 1.25),
            "drops": (4, 0, False, 0.3),
            "shared": (4, 0, True, 1.25)}


def _close(got, want, tol=TOL, err_msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol,
                               err_msg=err_msg)


def _layer(variant, d=32, f=48, seed=0):
    """The reference's MoE parameters, the same in the port, and an input
    x (2, 32, d) from a numpy seed."""
    e, pad_to, shared, _ = VARIANTS[variant]
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), d, e, f,
                          shared_expert=shared, pad_to=pad_to)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 32, d), dtype=np.float32)
    return jp, params_from_numpy(_flatten(jp), device="cpu"), x


def _kw(variant, top_k, dispatch):
    e, _, _, cf = VARIANTS[variant]
    return dict(n_experts=e, top_k=top_k, capacity_factor=cf,
                dispatch=dispatch, group_size=16)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter", "dense"])
def test_moe_forward_matches_reference(variant, top_k, dispatch):
    jp, tp, x = _layer(variant)
    kw = _kw(variant, top_k, dispatch)
    want, want_aux = jax_moe.moe_forward(jp, jnp.asarray(x), **kw)
    got, aux = moe.moe_forward(tp, torch.from_numpy(x), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got.numpy(), want)
    _close(float(aux), float(want_aux))


@pytest.mark.parametrize("dispatch", ["einsum", "scatter", "dense"])
@pytest.mark.parametrize("variant", ["drops", "shared"])
def test_moe_gradients_match_jax_grad(dispatch, variant):
    """d/d(params, x) of sum(y * w) + aux: through the gates, the kept
    slots' experts, the shared expert and the router's aux term."""
    jp, tp, x = _layer(variant, seed=3)
    kw = _kw(variant, 2, dispatch)
    w = np.random.default_rng(9).standard_normal(x.shape, dtype=np.float32)

    def jax_loss(p, x):
        y, aux = jax_moe.moe_forward(p, x, **kw)
        return jnp.sum(y * jnp.asarray(w)) + aux
    gp, gx = jax.grad(jax_loss, (0, 1))(jp, jnp.asarray(x))

    flat = {k: t.requires_grad_(True) for k, t in flatten(tp).items()}
    from repro_torch.tree import unflatten
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_forward(unflatten(flat), xt, **kw)
    loss = (y * torch.from_numpy(w)).sum() + aux
    grads = torch.autograd.grad(loss, [xt] + list(flat.values()))
    _close(grads[0].numpy(), gx, err_msg="x")
    want = _flatten(gp)
    assert sorted(want) == sorted(flat)
    for key, g in zip(flat, grads[1:]):
        _close(g.numpy(), want[key], err_msg=key)


def test_top_k_breaks_ties_as_jax():
    """Equal probabilities: the lower expert index first, as
    ``jax.lax.top_k`` (padded experts all have probability 0)."""
    probs = np.array([[0.25, 0.0, 0.25, 0.5, 0.0, 0.0],
                      [0.0, 0.0, 0.0, 0.0, 0.5, 0.5],
                      [1 / 3, 1 / 3, 0.0, 1 / 3, 0.0, 0.0]], np.float32)
    for k in (1, 2, 4, 6):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.stable_top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("seed", range(4))
def test_capacity_positions_match_reference(seed):
    """k-priority slot positions and keeps, bitwise, on random choices
    with collisions (capacity 3 for 8 tokens of top-3 over 4 experts)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 4, (2, 8, 3))
    onehot = jax.nn.one_hot(jnp.asarray(idx, jnp.int32), 4, dtype=jnp.int32)
    want_pos, want_keep = jax_moe._top_k_positions(onehot, None, 4, 3)
    pos, keep = moe._top_k_positions(moe._one_hot(
        torch.from_numpy(idx), 4, torch.int64), 3)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))


# -- twins of the reference's tests/test_moe.py ------------------------ #
def _port_layer(e=4, d=32, f=64, pad_to=0, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = moe.moe_init(gen, d, e, f, pad_to=pad_to, dtype=torch.float32,
                     device="cpu")
    x = torch.randn((2, 16, d), generator=gen) * 0.5
    return p, x


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_einsum_matches_dense_oracle(top_k):
    p, x = _port_layer()
    y_ein, aux1 = moe.moe_forward(p, x, n_experts=4, top_k=top_k,
                                  capacity_factor=8.0)   # no drops
    y_dense, aux2 = moe.moe_forward(p, x, n_experts=4, top_k=top_k,
                                    dispatch="dense")
    np.testing.assert_allclose(y_ein.numpy(), y_dense.numpy(), atol=2e-5,
                               rtol=2e-4)
    np.testing.assert_allclose(float(aux1), float(aux2), rtol=1e-6)


def test_padded_experts_get_no_tokens():
    p, x = _port_layer(e=3, pad_to=8)
    assert p["router"]["w"].shape[-1] == 8
    logits = x @ p["router"]["w"]
    probs = torch.softmax(torch.where(torch.arange(8) >= 3,
                                      torch.full_like(logits, -1e30),
                                      logits), dim=-1)
    assert float(probs[..., 3:].max()) == 0.0
    y, aux = moe.moe_forward(p, x, n_experts=3, top_k=2,
                             capacity_factor=8.0)
    assert bool(torch.isfinite(y).all())
    _, idx = moe.stable_top_k(probs, 2)
    assert int(idx.max()) < 3


def test_capacity_drops_reduce_output():
    p, x = _port_layer()
    y_full, _ = moe.moe_forward(p, x, n_experts=4, top_k=2,
                                capacity_factor=8.0)
    y_tight, _ = moe.moe_forward(p, x, n_experts=4, top_k=2,
                                 capacity_factor=0.05)
    assert float((y_full - y_tight).abs().max()) > 1e-4


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 3))
def test_positions_respect_capacity_property(seed, top_k):
    """Kept positions are < capacity, and no (expert, slot) pair is used
    twice within a group."""
    rng = np.random.default_rng(seed)
    G, g, E, cap = 2, 8, 4, 3
    idx = torch.as_tensor(rng.integers(0, E, (G, g, top_k)))
    pos, keep = moe._top_k_positions(moe._one_hot(idx, E, torch.int64),
                                     cap)
    pos, keep = pos.numpy(), keep.numpy()
    assert (pos[keep] < cap).all()
    for gi in range(G):
        used = set()
        for ti in range(g):
            for ki in range(top_k):
                if keep[gi, ti, ki]:
                    key = (int(idx[gi, ti, ki]), int(pos[gi, ti, ki]))
                    assert key not in used, "slot collision"
                    used.add(key)


def test_unknown_dispatch_and_ragged_group_raise():
    p, x = _port_layer()
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_forward(p, x, n_experts=4, top_k=2, dispatch="gather")
    with pytest.raises(ValueError, match="group"):
        moe.moe_forward(p, x, n_experts=4, top_k=2, group_size=6)


# -- the moe family ---------------------------------------------------- #
def _configs(name, **kw):
    jc = dataclasses.replace(jax_config(name).reduced(), dtype="float32",
                             **kw)
    tc = dataclasses.replace(get_config(name).reduced(), dtype="float32",
                             **kw)
    return jc, tc


_SETUPS = {}


def _setup(name, **kw):
    key = (name, tuple(sorted(kw.items())))
    if key not in _SETUPS:
        jc, tc = _configs(name, **kw)
        jp = jax_init(jc, jax.random.PRNGKey(0))
        _SETUPS[key] = (jc, tc, jp,
                        params_from_numpy(_flatten(jp), device="cpu"))
    return _SETUPS[key]


def test_moe_units_hold_the_reference_layout():
    """llama4-maverick's unit is a dense sub0 and a MoE sub1 with the
    shared expert; granite's a MoE sub0 alone, 40 -> 4 experts reduced."""
    _, tc, jp, tp = _setup("llama4-maverick-400b-a17b")
    keys = set(flatten(tp))
    assert "units/sub0/mlp/gate/w" in keys
    assert "units/sub1/ffn/experts/gate" in keys
    assert "units/sub1/ffn/shared/down/w" in keys
    assert flatten(tp)["units/sub1/ffn/experts/down"].shape == (
        tc.n_units, tc.moe_experts, tc.moe_d_ff, tc.d_model)
    _, tc, _, tp = _setup("granite-moe-3b-a800m")
    assert sorted({k.split("/")[1] for k in flatten(tp)
                   if k.startswith("units/")}) == ["sub0"]
    assert flatten(tp)["units/sub0/ffn/router/w"].shape == (
        tc.n_units, tc.d_model, 4)


def test_moe_accumulated_equals_full_batch():
    """The twin of the reference's ``test_moe_grads_match``: with
    ``aux_loss_weight=0`` (the aux loss is a batch statistic) and no
    drops, 4 accumulated micro-batches give the full batch's gradients."""
    _, tc = _configs("granite-moe-3b-a800m", moe_capacity_factor=8.0)
    params = init_params(tc, 0, device="cpu")
    batch = make_batch(tc, 8, 32, device="cpu")
    lg = make_loss_and_grad(tc, TrainConfig(aux_loss_weight=0.0))
    loss_full, g_full = accumulate_gradients(lg, params, batch, 1)
    loss_acc, g_acc = accumulate_gradients(lg, params, batch, 4)
    np.testing.assert_allclose(float(loss_acc), float(loss_full),
                               rtol=1e-5, atol=1e-6)
    fa, ff = flatten(g_acc), flatten(g_full)
    assert sorted(fa) == sorted(flatten(params))
    for key in ff:
        np.testing.assert_allclose(fa[key].numpy(), ff[key].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=key)


def _prompt(cfg, batch, plen, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, plen))


@pytest.mark.parametrize("name", MOE_MODELS)
@pytest.mark.parametrize("dispatch", ["einsum", "dense"])
def test_moe_prefill_and_decode_match_reference(name, dispatch):
    jc, tc, jp, tp = _setup(name, moe_dispatch=dispatch)
    prompt = _prompt(jc, 2, 16, 0)
    max_len = 32
    want, jcache = jax_prefill(jc, jp, jax_init_cache(jc, 2, max_len),
                               jnp.asarray(prompt, jnp.int32))
    got, cache = prefill(tc, tp, init_cache(tc, 2, max_len, device="cpu"),
                         torch.as_tensor(prompt))
    _close(got.numpy(), want, LOGIT_TOL)
    jflat, tflat = _flatten(jcache["units"]), flatten(cache["units"])
    assert sorted(jflat) == sorted(tflat)
    assert any(k.startswith("sub") for k in tflat)
    for key in jflat:
        _close(tflat[key].numpy(), jflat[key], LOGIT_TOL, key)
    toks = _prompt(jc, 2, 4, 1)
    for t in range(4):
        want, jcache = jax_decode_step(jc, jp, jcache,
                                       jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32))
        got, cache = decode_step(tc, tp, cache,
                                 torch.as_tensor(toks[:, t:t + 1]))
        _close(got.numpy(), want, LOGIT_TOL)
    assert int(cache["index"]) == int(jcache["index"]) == 20


@pytest.mark.parametrize("name", MOE_MODELS)
def test_moe_prefill_extend_matches_reference(name):
    """The suffix prefill under the dense dispatch, from the reference's
    prefix cache in both packages."""
    jc, tc, jp, tp = _setup(name, moe_dispatch="dense")
    prompt = _prompt(jc, 1, 21, 2)
    start, max_len = 13, 32
    jcache = jax_prefill(jc, jp, jax_init_cache(jc, 1, max_len),
                         jnp.asarray(prompt[:, :start], jnp.int32))[1]
    cache = init_cache(tc, 1, max_len, device="cpu")
    for key, arr in _flatten(jcache["units"]).items():
        flatten(cache["units"])[key].copy_(torch.from_numpy(np.array(arr)))
    want, jc2 = jax_prefill_extend(jc, jp, jcache,
                                   jnp.asarray(prompt[:, start:], jnp.int32),
                                   start=start)
    got, c2 = prefill_extend(tc, tp, cache, torch.as_tensor(
        prompt[:, start:]), start=start)
    _close(got.numpy(), want, LOGIT_TOL)
    for key, arr in _flatten(jc2["units"]).items():
        _close(flatten(c2["units"])[key].numpy(), arr, LOGIT_TOL, key)
    # and the whole prefill's suffix rows inside the port
    full, _ = prefill(tc, tp, init_cache(tc, 1, max_len, device="cpu"),
                      torch.as_tensor(prompt))
    _close(got.numpy(), full[:, start:].numpy(), LOGIT_TOL)


@pytest.mark.parametrize("name", MOE_MODELS)
def test_moe_greedy_tokens_match_reference(name):
    jc, tc, jp, tp = _setup(name, moe_capacity_factor=8.0)
    from repro.launch import serve as jax_serve
    prompt = _prompt(jc, 2, 16, 4)
    want = np.asarray(jax_serve.generate(
        jc, jp, jnp.asarray(prompt, jnp.int32), max_new_tokens=8,
        max_len=32))
    got = serve.generate(tc, tp, torch.as_tensor(prompt), max_new_tokens=8,
                         max_len=32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", MOE_MODELS)
def test_moe_engines_equal_solo(name):
    """Under the dense dispatch (capacity factor 8, the reference's test
    override): paged == dense, prefix-shared == private, engine == solo
    ``generate``, token for token."""
    _, tc, _, tp = _setup(name, moe_dispatch="dense",
                          moe_capacity_factor=8.0)
    rng = np.random.default_rng(5)
    system = rng.integers(0, tc.vocab, 20)
    reqs = [(np.concatenate([system, rng.integers(0, tc.vocab,
                                                  int(rng.integers(3, 12)))]),
             int(rng.integers(4, 10))) for _ in range(5)]
    kw = dict(n_slots=2, max_len=64, segment=4)
    outs = {}
    for way, extra in (("dense", {}),
                       ("paged", dict(paged=True, page_size=8)),
                       ("shared", dict(paged=True, page_size=8,
                                       prefix_share=True, debug=True))):
        eng = DecodeEngine(tc, tp, **kw, **extra)
        rids = [eng.submit(p, n) for p, n in reqs]
        out = eng.run()
        outs[way] = [out[r] for r in rids]
        if way == "shared":
            assert eng.stats["prefix_hits"] > 0
    solo = [serve.generate(tc, tp, torch.as_tensor(p)[None, :],
                           max_new_tokens=n, max_len=64)[0].tolist()
            for p, n in reqs]
    assert outs["dense"] == solo
    assert outs["paged"] == outs["dense"]
    assert outs["shared"] == outs["paged"]


def test_prefix_share_admits_moe_only_under_the_dense_dispatch():
    _, tc, _, tp = _setup("granite-moe-3b-a800m")
    with pytest.raises(ValueError, match="moe_dispatch 'einsum'"):
        DecodeEngine(tc, tp, paged=True, prefix_share=True, max_len=64,
                     page_size=8)
    tc = dataclasses.replace(tc, moe_dispatch="dense")
    DecodeEngine(tc, tp, paged=True, prefix_share=True, max_len=64,
                 page_size=8)


def test_moe_forward_aux_matches_reference():
    """The model's summed aux (one MoE layer a unit) against the
    reference's, and nonzero."""
    from repro.models import forward as jax_forward
    from repro_torch.models import forward
    for name in MOE_MODELS:
        jc, tc, jp, tp = _setup(name)
        batch = make_batch(tc, 2, 32, device="cpu")
        _, want = jax_forward(jc, jp, {"tokens": jnp.asarray(
            batch["tokens"].numpy(), jnp.int32)})
        _, got = forward(tc, tp, batch)
        assert float(got) > 0
        _close(float(got), float(want))
        assert params_to_numpy(tp).keys() == _flatten(jp).keys()
