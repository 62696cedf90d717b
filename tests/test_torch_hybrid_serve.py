"""The port's hybrid serving (zamba2-7b) against the reference at reduced
size, in f32: the SSD with a state in and out, the Mamba2 prefill and
decode, the model's prefill, cache and decode steps; and, inside the
port, the engine's token identities.

The reduced config is the reference's ``reduced()`` (d_model 256, 4 SSM
heads of P = 128, N = 16, a shared block of 4 heads of 64) at one and
two units (9 and 18 layers; the 2-unit variant keeps two K/V caches of
the shared block). Parameters cross by ``params_from_numpy``; the
reference runs on the JAX CPU backend, the port on its plain versions.

Tolerances, after dividing by max(1, max|reference|): 1e-4 everywhere
against the reference (``test_torch_hybrid.py``'s: the same f32
arithmetic in another order through a few layers; the reference's SSD
chunk is 256, or S when S is no multiple of it, the port's 64). Inside
the port the identities are bitwise: engine == solo ``generate``,
paged == dense, a reused slot == a fresh one. Prefill plus decode
against the teacher-forced ``forward``: 1e-4, as against the reference.
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
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ssd
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import (decode_step, forward, init_cache,
                                init_paged_cache, prefill)
from repro_torch.models import ssm
from repro_torch.tree import flatten, tree_map
from _torch_threads import one_torch_thread  # noqa: F401

UNITS = [9, 18]                # n_layers: one unit, two units
TOL = 1e-4


def _configs(n_layers):
    jc = dataclasses.replace(jax_config("zamba2-7b").reduced(),
                             dtype="float32", n_layers=n_layers)
    tc = dataclasses.replace(get_config("zamba2-7b").reduced(),
                             dtype="float32", n_layers=n_layers)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _bridged(n_layers, seed=0):
    jc, tc = _configs(n_layers)
    jp = jax_init(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(_flatten(jp), device="cpu")


def _close(got, want, tol=TOL, err_msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               rtol=tol, err_msg=err_msg)


def _close_trees(got, want, tol=TOL):
    """Every leaf of the port's tree against the reference's, by key."""
    got, want = flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], np.asarray(want[key]), tol, err_msg=key)


def _prompt(tc, b, s, seed):
    return np.random.default_rng(seed).integers(0, tc.vocab, (b, s))


# ---------------------------------------------------------------------- #
# the SSD with a state in and out
# ---------------------------------------------------------------------- #
def _ssd_arrays(seed, b, s, h, p, n):
    """x, dt = softplus(N - 1), A = -exp(N / 2), Bm, Cm and a non-zero
    initial state, f32 numpy."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    dt = np.log1p(np.exp(r(b, s, h) - 1)).astype(np.float32)
    a = (-np.exp(r(h) * 0.5)).astype(np.float32)
    return r(b, s, h, p), dt, a, r(b, s, n), r(b, s, n), r(b, h, p, n)


@pytest.mark.parametrize("s", [37, 150])
def test_ssd_prefill_matches_reference(s):
    """A non-zero initial state and an S that is no multiple of the
    port's chunk of 64: the padded rows (dt = 0) leave the final state at
    the state after the last real row."""
    arrays = _ssd_arrays(s, 2, s, 4, 128, 16)
    x, dt, a, bm, cm, init = arrays
    want_y, want_state = jax_ssm.ssd_chunked(
        *map(jnp.asarray, (x, dt, a, bm, cm)),
        init_state=jnp.asarray(init), return_state=True)
    y, final = ops.ssd_prefill(*map(torch.from_numpy, arrays))
    assert final.dtype == torch.float32
    _close(y, np.asarray(want_y), err_msg="y")
    _close(final, np.asarray(want_state), err_msg="final state")


def test_ssd_prefill_continues_across_calls():
    """Two prefills, the second from the first's final state, give the
    one-call prefill over the whole sequence; with a zero initial state
    it is the training SSD. Forward only."""
    x, dt, a, bm, cm, init = map(torch.from_numpy,
                                 _ssd_arrays(5, 1, 100, 2, 64, 16))
    y, final = ops.ssd_prefill(x, dt, a, bm, cm, init)
    y1, mid = ops.ssd_prefill(x[:, :45], dt[:, :45], a, bm[:, :45],
                              cm[:, :45], init)
    y2, end = ops.ssd_prefill(x[:, 45:], dt[:, 45:], a, bm[:, 45:],
                              cm[:, 45:], mid)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(end, final, rtol=1e-5, atol=1e-5)
    y0, _ = ops.ssd_prefill(x, dt, a, bm, cm, torch.zeros_like(init))
    torch.testing.assert_close(y0, ops.ssd(x, dt, a, bm, cm), rtol=1e-6,
                               atol=1e-6)
    assert ssd.LAUNCHES == {"ssd_fwd": 0, "ssd_bwd": 0}
    with pytest.raises(ValueError, match="forward only"):
        ops.ssd_prefill(x.requires_grad_(True), dt, a, bm, cm, init)


# ---------------------------------------------------------------------- #
# the Mamba2 layer
# ---------------------------------------------------------------------- #
def test_mamba2_prefill_and_decode_match_reference():
    """One layer from a warm cache (random conv window and state): the
    prefill's output and cache, then three decode steps."""
    jc, tc, jp, params = _bridged(9)
    i = 4
    jl = jax.tree.map(lambda t: t[0, i], jp["units"]["mamba"]["mamba"])
    tl = tree_map(lambda t: t[0, i], params["units"]["mamba"]["mamba"])
    kw = dict(d_inner=tc.d_inner, ssm_state=tc.ssm_state,
              n_heads=tc.n_ssm_heads)
    rng = np.random.default_rng(11)
    b = 2
    jcache = jax_ssm.mamba2_init_cache(b, tc.d_inner, tc.ssm_state,
                                       tc.n_ssm_heads, tc.ssm_conv)
    jcache = {k: jnp.asarray(rng.standard_normal(v.shape, np.float32))
              for k, v in jcache.items()}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    assert {k: tuple(v.shape) for k, v in ssm.mamba2_init_cache(
        b, tc.d_inner, tc.ssm_state, tc.n_ssm_heads, tc.ssm_conv,
        dtype=torch.float32, device="cpu").items()} == {
        k: v.shape for k, v in jcache.items()}
    x = rng.standard_normal((b, 21, tc.d_model), dtype=np.float32)
    want, jcache = jax_ssm.mamba2_prefill(jl, jnp.asarray(x), jcache, **kw)
    got, cache = ssm.mamba2_prefill(tl, torch.from_numpy(x), cache, **kw)
    _close(got, np.asarray(want), err_msg="prefill out")
    _close_trees(cache, jcache)
    for step in range(3):
        xt = rng.standard_normal((b, 1, tc.d_model), dtype=np.float32)
        want, jcache = jax_ssm.mamba2_decode(jl, jnp.asarray(xt), jcache,
                                             **kw)
        got, cache = ssm.mamba2_decode(tl, torch.from_numpy(xt), cache, **kw)
        _close(got, np.asarray(want), err_msg=f"decode {step}")
        _close_trees(cache, jcache)


# ---------------------------------------------------------------------- #
# the model
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n_layers", UNITS)
def test_prefill_cache_and_decode_match_reference(n_layers):
    """The prefill's logits and every cache leaf (each Mamba2 layer's conv
    window and state, each shared-block application's K/V), then 8
    teacher-forced decode steps, each fed the reference's greedy token,
    so that a near tie cannot compound."""
    jc, tc, jp, params = _bridged(n_layers)
    b, plen, max_len = 2, 21, 48
    prompt = _prompt(tc, b, plen, n_layers)
    jlogits, jcache = jax.jit(functools.partial(jax_prefill, jc))(
        jp, jax_init_cache(jc, b, max_len), jnp.asarray(prompt, jnp.int32))
    logits, cache = prefill(tc, params, init_cache(tc, b, max_len,
                                                   device="cpu"),
                            torch.from_numpy(prompt))
    _close(logits, np.asarray(jlogits), err_msg="prefill logits")
    _close_trees(cache["units"], jcache["units"])
    assert int(cache["index"]) == int(jcache["index"]) == plen
    jstep = jax.jit(functools.partial(jax_decode_step, jc))
    tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    for step in range(8):
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(tok, jnp.int32))
        logits, cache = decode_step(tc, params, cache, torch.from_numpy(tok))
        _close(logits, np.asarray(jlogits), err_msg=f"decode step {step}")
        tok = np.array(jnp.argmax(jlogits, axis=-1))
    _close_trees(cache["units"], jcache["units"])
    assert int(cache["index"]) == plen + 8


@pytest.mark.parametrize("n_layers", UNITS)
def test_prefill_and_decode_equal_the_teacher_forced_forward(n_layers):
    """Prefill's logits at every prompt position, then each decode step's,
    are the training forward's over the whole sequence."""
    _, tc, _, params = _bridged(n_layers)
    seq = _prompt(tc, 2, 29, 100 + n_layers)
    tokens = torch.from_numpy(seq)
    full, _ = forward(tc, params, {"tokens": tokens}, remat=False)
    plen = 19
    logits, cache = prefill(tc, params, init_cache(tc, 2, 32, device="cpu"),
                            tokens[:, :plen])
    _close(logits, full[:, :plen], err_msg="prefill")
    for t in range(plen, seq.shape[1]):
        logits, cache = decode_step(tc, params, cache, tokens[:, t:t + 1])
        _close(logits[:, 0], full[:, t], err_msg=f"position {t}")


def test_paged_cache_pages_only_the_shared_block():
    """The K/V of each shared-block application becomes a pool with a
    scratch page; the Mamba2 leaves stay dense per slot."""
    _, tc = _configs(18)
    dense = flatten(init_cache(tc, 3, 64, device="cpu"))
    paged = flatten(init_paged_cache(tc, 3, 64, page_size=8, n_pages=10,
                                     device="cpu"))
    u, n_units = tc.pattern_unit(), tc.n_units
    assert paged["units/mamba/state"].shape == dense[
        "units/mamba/state"].shape == (n_units, u, 3, tc.n_ssm_heads,
                                       tc.d_inner // tc.n_ssm_heads,
                                       tc.ssm_state)
    assert paged["units/mamba/state"].dtype == torch.float32
    assert paged["units/mamba/conv"].shape == (
        n_units, u, 3, tc.ssm_conv - 1, tc.d_inner + 2 * tc.ssm_state)
    assert dense["units/shared/k"].shape == (n_units, 3, 64, tc.n_kv_heads,
                                             tc.head_dim)
    assert paged["units/shared/v"].shape == (n_units, 11, 8, tc.n_kv_heads,
                                             tc.head_dim)
    assert paged["pages"].shape == (3, 8)


# ---------------------------------------------------------------------- #
# the engine, inside the port
# ---------------------------------------------------------------------- #
def _requests(tc, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, tc.vocab, int(rng.integers(3, 30))),
             int(rng.integers(4, 14))) for _ in range(n)]


def _run(tc, params, reqs, **kw):
    eng = DecodeEngine(tc, params, max_len=64, segment=4, debug=True, **kw)
    rids = [eng.submit(p, n) for p, n in reqs]
    out = eng.run()
    return [out[r] for r in rids], eng


def test_engine_equals_solo_and_paged_equals_dense():
    """Six requests through 2 slots, so slots are reused mid-run; every
    token bitwise."""
    _, tc, _, params = _bridged(18)
    reqs = _requests(tc, 6, 1)
    dense, eng = _run(tc, params, reqs, n_slots=2)
    paged, _ = _run(tc, params, reqs, n_slots=2, paged=True, page_size=8)
    solo = [serve.generate(tc, params, torch.as_tensor(p)[None, :],
                           max_new_tokens=n, max_len=64)[0].tolist()
            for p, n in reqs]
    assert eng.stats["admitted"] == 6 and eng.stats["segments"] > 3
    assert [len(o) for o in dense] == [n for _, n in reqs]
    assert dense == solo
    assert paged == dense


@pytest.mark.parametrize("paged", [False, True])
def test_a_reused_slot_gives_a_fresh_slots_tokens(paged):
    """One slot serves two requests in turn: the second's tokens equal
    those of a fresh engine that serves it alone, so nothing of the
    first request's Mamba2 state, conv window or K/V carries over."""
    _, tc, _, params = _bridged(9)
    first, second = _requests(tc, 2, 2)
    kw = dict(n_slots=1, paged=paged, page_size=8) if paged else {
        "n_slots": 1}
    both, _ = _run(tc, params, [first, second], **kw)
    alone, _ = _run(tc, params, [second], **kw)
    assert both[1] == alone[0]
