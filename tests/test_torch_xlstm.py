"""The port's xlstm-1.3b (the ssm family) against the reference at
reduced size, in f32: the mLSTM's chunkwise scan and its one-token
recurrence, the sLSTM's scan, the model's forward logits, loss and
gradients, prefill and decode with every cache leaf; and, inside the
port, decode == forward, accumulated == full batch and the engine's
token identities. xLSTM runs no kernel, on the card or here.

The reduced config is the reference's ``reduced()``: one unit of 7 mLSTM
layers (4 heads of 128) and one sLSTM layer (4 heads of 64), d_model
256. Weights cross by ``params_from_numpy``; inputs come from numpy
seeds. Tolerances, after dividing by max(1, max|reference|): logits
1e-4, one layer's outputs, states and gradients 1e-5
(``test_torch_families.py``'s). One layer agrees to a few f32 ulps
(the scans' tests, the long and multi-chunk ones among them). Through
the eight layers of the model the recurrences amplify rounding: within
the port alone, weights moved by 6e-8 relative (one f32 ulp) move the
gradients by up to 1.6e-5 (``embed/table``, batch 2 x 32) and the
logits by a few 1e-5 at 256 tokens. So the model's gradients and cache
states take ``MODEL_TOL`` = 5e-5, three times that measured
sensitivity, and its logits 1e-4 on prompts of 64 tokens or fewer.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.npz import _flatten
from repro.configs import get_config as jax_config
from repro.data import make_batch as jax_batch
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import param_count as jax_param_count
from repro.models import prefill as jax_prefill
from repro.models import xlstm as jax_xlstm
from repro.train.train_step import loss_fn as jax_loss_fn
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.kernels import flash_attention, flash_decode, ssd
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import (decode_step, forward, init_cache,
                                init_paged_cache, init_params, param_count,
                                prefill)
from repro_torch.models import xlstm
from repro_torch.models.model import layered_units
from repro_torch.train import (TrainConfig, accumulate_gradients,
                               make_loss_and_grad)
from repro_torch.tree import flatten, grad_leaves
from _torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL, TOL, MODEL_TOL = 1e-4, 1e-5, 5e-5
NAME = "xlstm-1.3b"


def _close(got, want, tol=TOL, err_msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               rtol=tol, err_msg=err_msg)


def _close_trees(got, want, tol=MODEL_TOL):
    got, want = flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], np.asarray(want[key]), tol, err_msg=key)


def _configs():
    jc = dataclasses.replace(jax_config(NAME).reduced(), dtype="float32")
    tc = dataclasses.replace(get_config(NAME).reduced(), dtype="float32")
    return jc, tc


@functools.lru_cache(maxsize=None)
def _bridged(seed=0):
    jc, tc = _configs()
    jp = jax_init(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(_flatten(jp), device="cpu")


def _no_kernel_launched():
    launches = {**flash_attention.LAUNCHES, **flash_decode.LAUNCHES,
                **ssd.LAUNCHES}
    assert not any(launches.values()), launches


# ---------------------------------------------------------------------- #
# the mLSTM
# ---------------------------------------------------------------------- #
def _mlstm_arrays(seed, b, s, h, d):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    f_log = -np.log1p(np.exp(-r(b, s, h) - 2)).astype(np.float32)
    return r(b, s, h, d), r(b, s, h, d), r(b, s, h, d), r(b, s, h), f_log


@pytest.mark.parametrize("s", [512, 100])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_matches_reference(s, with_state):
    """Two chunks of 256 (the carry between them runs) and a ragged S,
    which runs as one chunk of S; from zeros or from a non-zero state,
    with the final (C, n, m)."""
    q, k, v, i_log, f_log = _mlstm_arrays(s, 2, s, 4, 32)
    rng = np.random.default_rng(7)
    init = (rng.standard_normal((2, 4, 32, 32), dtype=np.float32) * 0.1,
            rng.standard_normal((2, 4, 32), dtype=np.float32) * 0.1,
            rng.standard_normal((2, 4), dtype=np.float32))
    kw = dict(return_state=True)
    if with_state:
        want, jstate = jax_xlstm.mlstm_chunked(
            *map(jnp.asarray, (q, k, v, i_log, f_log)),
            init_state=tuple(map(jnp.asarray, init)), **kw)
        got, state = xlstm.mlstm_chunked(
            *map(torch.from_numpy, (q, k, v, i_log, f_log)),
            init_state=tuple(map(torch.from_numpy, init)), **kw)
    else:
        want, jstate = jax_xlstm.mlstm_chunked(
            *map(jnp.asarray, (q, k, v, i_log, f_log)), **kw)
        got, state = xlstm.mlstm_chunked(
            *map(torch.from_numpy, (q, k, v, i_log, f_log)), **kw)
        alone = xlstm.mlstm_chunked(
            *map(torch.from_numpy, (q, k, v, i_log, f_log)))
        torch.testing.assert_close(alone, got, rtol=0, atol=0)
    _close(got, np.asarray(want), err_msg="h")
    for name, a, b in zip("Cnm", state, jstate):
        assert a.dtype == torch.float32
        _close(a, np.asarray(b), err_msg=name)


def _slice_tree(tree, *index):
    return {k: (_slice_tree(v, *index) if isinstance(v, dict) else v[index])
            for k, v in tree.items()}


def _mlstm_layer(i=3):
    """Layer ``i`` of the unit's mLSTM stack, the reference's and the
    port's."""
    jc, tc, jp, params = _bridged()
    jl = jax.tree.map(lambda t: t[0, i], jp["units"]["mlstm"]["mlstm"])
    return tc, jl, _slice_tree(params["units"]["mlstm"]["mlstm"], 0, i)


def test_mlstm_prefill_and_decode_match_reference():
    """One mLSTM layer from a warm cache: the prefill's output and (C, n,
    m), then four decode steps, each against the reference's."""
    tc, jl, tl = _mlstm_layer()
    kw = dict(d_inner=tc.d_inner, n_heads=tc.n_heads)
    rng = np.random.default_rng(12)
    b = 2
    jcache = jax_xlstm.mlstm_init_cache(b, tc.d_inner, tc.n_heads)
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape, np.float32) * 0.1)
              for k, v in jcache.items()}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    assert {k: tuple(v.shape) for k, v in xlstm.mlstm_init_cache(
        b, tc.d_inner, tc.n_heads, device="cpu").items()} == {
        k: v.shape for k, v in jcache.items()}
    x = rng.standard_normal((b, 21, tc.d_model), dtype=np.float32)
    want, jcache = jax_xlstm.mlstm_prefill(jl, jnp.asarray(x), jcache, **kw)
    got, cache = xlstm.mlstm_prefill(tl, torch.from_numpy(x), cache, **kw)
    _close(got, np.asarray(want), err_msg="prefill out")
    for key in "Cnm":
        _close(cache[key], np.asarray(jcache[key]), err_msg=key)
    for step in range(4):
        xt = rng.standard_normal((b, 1, tc.d_model), dtype=np.float32)
        want, jcache = jax_xlstm.mlstm_decode(jl, jnp.asarray(xt), jcache,
                                              **kw)
        c_before = cache["C"]
        got, cache = xlstm.mlstm_decode(tl, torch.from_numpy(xt), cache, **kw)
        assert cache["C"] is c_before            # updated in place
        _close(got, np.asarray(want), err_msg=f"decode {step}")
        for key in "Cnm":
            _close(cache[key], np.asarray(jcache[key]),
                   err_msg=f"{key} {step}")


@pytest.mark.parametrize("s", [300, 40])
def test_mlstm_decode_step_by_step_equals_chunked(s):
    """Inside the port: S one-token decode steps from a zero cache give
    the chunkwise form's outputs and final state (300 tokens: one chunk
    of 256 and a ragged rest in the prefill below; 40: one chunk)."""
    tc, _, tl = _mlstm_layer(1)
    kw = dict(d_inner=tc.d_inner, n_heads=tc.n_heads)
    x = torch.from_numpy(np.random.default_rng(s).standard_normal(
        (2, s, tc.d_model), dtype=np.float32))
    full = xlstm.mlstm_forward(tl, x, **kw)
    pre_cache = xlstm.mlstm_init_cache(2, tc.d_inner, tc.n_heads,
                                       device="cpu")
    pre, pre_cache = xlstm.mlstm_prefill(tl, x, pre_cache, **kw)
    torch.testing.assert_close(pre, full, rtol=0, atol=0)
    cache = xlstm.mlstm_init_cache(2, tc.d_inner, tc.n_heads, device="cpu")
    outs = []
    for t in range(s):
        y, cache = xlstm.mlstm_decode(tl, x[:, t:t + 1], cache, **kw)
        outs.append(y)
    _close(torch.cat(outs, dim=1), full.numpy(), err_msg="h")
    for key in "Cnm":
        _close(cache[key], pre_cache[key].numpy(), err_msg=key)


# ---------------------------------------------------------------------- #
# the sLSTM
# ---------------------------------------------------------------------- #
def _slstm_inputs(seed, b, s):
    jc, tc, jp, params = _bridged()
    jl = jax.tree.map(lambda t: t[0], jp["units"]["slstm"]["slstm"])
    tl = _slice_tree(params["units"]["slstm"]["slstm"], 0)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, 4 * tc.d_model), dtype=np.float32)
    state = [rng.standard_normal((b, tc.d_model), dtype=np.float32) * 0.1
             for _ in range(4)]
    state[2] = np.abs(state[2]) + 1e-6               # n > 0
    return tc, jl, tl, u, state


def test_slstm_scan_matches_reference():
    """The recurrence from a non-zero state over 50 tokens: every h and
    the final (h, c, n, m); the gates are split after the head-major
    reshape of the recurrent sum, as in the reference."""
    tc, jl, tl, u, state = _slstm_inputs(4, 2, 50)
    want, jfinal = jax_xlstm._slstm_scan(
        jl, jnp.asarray(u), *map(jnp.asarray, state), tc.n_heads)
    got, final = xlstm._slstm_scan(tl, torch.from_numpy(u),
                                   *map(torch.from_numpy, state), tc.n_heads)
    _close(got, np.asarray(want), err_msg="hs")
    for name, a, b in zip("hcnm", final, jfinal):
        _close(a, np.asarray(b), err_msg=name)


def test_slstm_scan_gradients_match_jax_grad():
    """d(sum(hs * w)) with respect to u, the recurrent weights r, the
    bias and the initial state, against ``jax.grad``."""
    tc, jl, tl, u, state = _slstm_inputs(5, 2, 24)
    w = np.random.default_rng(6).standard_normal(
        (2, 24, tc.d_model), dtype=np.float32)

    def jloss(r, b, u, h0, c0):
        hs, _ = jax_xlstm._slstm_scan({"r": r, "b": b}, u, h0, c0,
                                      jnp.asarray(state[2]),
                                      jnp.asarray(state[3]), tc.n_heads)
        return jnp.sum(hs * jnp.asarray(w))
    args = (jl["r"], jl["b"], jnp.asarray(u), jnp.asarray(state[0]),
            jnp.asarray(state[1]))
    want = jax.grad(jloss, argnums=tuple(range(5)))(*args)
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True)
              for a in args]
    hs, _ = xlstm._slstm_scan({"r": leaves[0], "b": leaves[1]}, leaves[2],
                              leaves[3], leaves[4],
                              torch.from_numpy(state[2]),
                              torch.from_numpy(state[3]), tc.n_heads)
    got = torch.autograd.grad((hs * torch.from_numpy(w)).sum(), leaves)
    for name, a, b in zip(("r", "b", "u", "h0", "c0"), got, want):
        _close(a, np.asarray(b), err_msg=name)


def test_slstm_prefill_is_decode_over_the_prompt():
    """The sLSTM's cache: n starts at 1e-6, and one call over S tokens
    leaves the state of S one-token calls, written in place; from a
    fresh cache it is the training forward, bit for bit."""
    tc, _, tl, _, _ = _slstm_inputs(0, 2, 1)
    cache = xlstm.slstm_init_cache(2, tc.d_model, device="cpu")
    assert float(cache["n"].min()) == float(cache["n"].max()) == \
        float(np.float32(1e-6))
    assert all(float(cache[k].abs().max()) == 0 for k in "hcm")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 9, tc.d_model), dtype=np.float32))
    step = xlstm.slstm_init_cache(2, tc.d_model, device="cpu")
    outs = [xlstm.slstm_decode(tl, x[:, t:t + 1], step,
                               n_heads=tc.n_heads)[0] for t in range(9)]
    n_before = cache["n"]
    y, cache = xlstm.slstm_decode(tl, x, cache, n_heads=tc.n_heads)
    assert cache["n"] is n_before
    # the input projection of 9 rows and of 1 row round apart
    _close(torch.cat(outs, dim=1), y.numpy(), err_msg="out")
    for key in "hcnm":
        _close(step[key], cache[key].numpy(), err_msg=key)
    torch.testing.assert_close(
        y, xlstm.slstm_forward(tl, x, n_heads=tc.n_heads), rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# the model
# ---------------------------------------------------------------------- #
def test_init_layout_and_count_match_reference():
    jc, tc = _configs()
    jp = jax_init(jc, jax.random.PRNGKey(0))
    params = init_params(tc, 0, device="cpu")
    want = {k: (v.shape, str(v.dtype)) for k, v in _flatten(jp).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten(params).items()}
    assert got == want
    assert param_count(params) == jax_param_count(jp)
    assert got["units/mlstm/mlstm/in_proj/w"][0] == (
        1, 7, 256, 4 * tc.d_inner + 2 * tc.n_heads)
    assert got["units/slstm/slstm/r"][0] == (1, 4, 64, 256)


@pytest.mark.parametrize("batch,seq,seed", [(2, 64, 3), (1, 37, 5)])
def test_forward_logits_match_reference(batch, seq, seed):
    jc, tc, jp, params = _bridged()
    jb = jax_batch(jc, batch, seq, seed=seed)
    tb = make_batch(tc, batch, seq, seed=seed, device="cpu")
    for key in jb:
        np.testing.assert_array_equal(np.asarray(jb[key]), tb[key].numpy())
    want, _ = jax_forward(jc, jp, jb)
    got, aux = forward(tc, params, tb)
    _close(got.detach(), np.asarray(want), LOGIT_TOL)
    assert float(aux) == 0.0
    _no_kernel_launched()


def test_loss_and_gradients_of_every_leaf_match_reference():
    """Through the port's train path: one leaf per (unit, mLSTM layer)
    for the mLSTM stack, one per unit for the sLSTM."""
    jc, tc, jp, params = _bridged()
    tb = make_batch(tc, 2, 32, seed=3, device="cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    (want_loss, _), want_grads = jax.value_and_grad(
        lambda p: jax_loss_fn(jc, p, jb), has_aux=True)(jp)
    loss, grads = accumulate_gradients(make_loss_and_grad(tc, TrainConfig()),
                                       params, tb, 1)
    _close(float(loss), float(want_loss))
    got, want = params_to_numpy(grads), _flatten(want_grads)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], MODEL_TOL, err_msg=key)
    assert layered_units(tc) == ("mlstm",)
    split, slots = grad_leaves(params, layered_units(tc))
    assert len(split["units"]) == 1 and len(split["units"][0]["mlstm"]) == 7
    assert [i for k, i, _ in slots if k == "units/slstm/slstm/r"] == [(0,)]
    assert [i for k, i, _ in slots if k == "units/mlstm/ln/scale"] == [
        (0, i) for i in range(7)]


@pytest.mark.parametrize("batch,accum", [(4, 2), (5, 3)])
def test_accumulated_equals_full_batch(batch, accum):
    """``test_torch_train.py``'s identity and tolerances."""
    _, tc = _configs()
    params = init_params(tc, 0, device="cpu")
    data = make_batch(tc, batch, 24, device="cpu")
    lg = make_loss_and_grad(tc, TrainConfig())
    loss_full, g_full = accumulate_gradients(lg, params, data, 1)
    loss_acc, g_acc = accumulate_gradients(lg, params, data, accum)
    torch.testing.assert_close(loss_acc, loss_full, rtol=1e-5, atol=1e-6)
    fa, ff = flatten(g_acc), flatten(g_full)
    assert sorted(fa) == sorted(flatten(params))
    for key in ff:
        torch.testing.assert_close(fa[key], ff[key], rtol=5e-4, atol=5e-6)


def test_prefill_cache_and_decode_match_reference():
    """The prefill's logits and every cache leaf (each mLSTM layer's C,
    n, m; the sLSTM's h, c, n, m), then 6 teacher-forced decode steps
    fed the reference's greedy token."""
    jc, tc, jp, params = _bridged()
    b, plen = 2, 21
    prompt = np.random.default_rng(9).integers(0, tc.vocab, (b, plen))
    jlogits, jcache = jax.jit(functools.partial(jax_prefill, jc))(
        jp, jax_init_cache(jc, b, 32), jnp.asarray(prompt, jnp.int32))
    cache = init_cache(tc, b, 32, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten(cache["units"]).items()} \
        == {k: v.shape for k, v in _flatten(jcache["units"]).items()}
    logits, cache = prefill(tc, params, cache, torch.from_numpy(prompt))
    _close(logits, np.asarray(jlogits), LOGIT_TOL, "prefill logits")
    _close_trees(cache["units"], jcache["units"])
    assert int(cache["index"]) == plen
    jstep = jax.jit(functools.partial(jax_decode_step, jc))
    tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    for step in range(6):
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(tok, jnp.int32))
        logits, cache = decode_step(tc, params, cache, torch.from_numpy(tok))
        _close(logits, np.asarray(jlogits), LOGIT_TOL, f"decode {step}")
        _close_trees(cache["units"], jcache["units"])
        tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    _no_kernel_launched()


def test_decode_equals_forward():
    """Inside the port: a prefill of 10 tokens and 14 decode steps give
    the teacher-forced forward's logits at every position."""
    _, tc, _, params = _bridged()
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, tc.vocab, (2, 24)))
    with torch.no_grad():
        want, _ = forward(tc, params, {"tokens": toks})
    logits, cache = prefill(tc, params, init_cache(tc, 2, 32, device="cpu"),
                            toks[:, :10])
    got = [logits]
    for t in range(10, 24):
        logits, cache = decode_step(tc, params, cache, toks[:, t:t + 1])
        got.append(logits)
    _close(torch.cat(got, dim=1), want.numpy(), LOGIT_TOL)


def test_generate_and_engine_equal_solo():
    """``generate`` scan == eager, and the dense engine with more
    requests than slots gives each request its solo tokens: an admission
    writes a fresh prefill's state, sLSTM n = 1e-6 included, into the
    slot. Paging and prefix sharing are refused: no linear K/V."""
    _, tc, _, params = _bridged()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tc.vocab, (pl,)) for pl in (5, 9, 3, 8, 6)]
    news = [7, 4, 9, 6, 5]
    eng = DecodeEngine(tc, params, n_slots=2, max_len=32, segment=4)
    rids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    out = eng.run()
    assert eng.stats["admitted"] == len(prompts)
    for rid, p, n in zip(rids, prompts, news):
        solo = serve.generate(tc, params, torch.as_tensor(p)[None],
                              max_new_tokens=n, max_len=32)
        assert out[rid] == solo[0].tolist(), rid
    p = torch.as_tensor(prompts[1])[None]
    torch.testing.assert_close(
        serve.generate(tc, params, p, max_new_tokens=6, engine="scan"),
        serve.generate(tc, params, p, max_new_tokens=6, engine="eager"),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="linear"):
        DecodeEngine(tc, params, paged=True, max_len=32, page_size=8)
    with pytest.raises(ValueError, match="recurrent state"):
        DecodeEngine(tc, params, paged=True, prefix_share=True, max_len=32,
                     page_size=8)
    with pytest.raises(ValueError, match="linear"):
        init_paged_cache(tc, 2, 32, page_size=8, n_pages=4, device="cpu")
