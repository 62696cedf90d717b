"""The sliding-window ring buffer: the port's windowed prefill and decode
against the reference at reduced size in f32 (glm4-9b with a window, the
reference's ``tests/test_decode.py`` case), and the finding the port's
ring decode rests on: for a ring of S <= window rows, the reference's
mask (``_ring_abs_pos``) keeps exactly rows [0, min(index + 1, S)), so
the linear flash-decode kernel with those lengths computes the same
softmax over the same keys.

Tolerances, after dividing by max(1, max|reference|): logits and cache
rows 1e-4 through a model (``test_torch_model.py``'s), one attention
block 1e-5 (one layer of f32 arithmetic in another order); the ring mask
against the prefix, and tokens, exactly. Greedy tokens are compared
only where the reference's top-two margin is above 1e-4 (as
``test_torch_serve.py`` does)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.checkpoint.npz import _flatten
from repro.configs import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.attention import _ring_abs_pos
from repro.models.attention import attention_decode as jax_attention_decode
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.models.attention import attention_decode
from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


def _close(got, want, tol=TOL, err_msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol,
                               err_msg=err_msg)


_SETUPS = {}


def _setup(window):
    """glm4-9b reduced, f32, with ``window``: both packages' configs and
    the reference's weights in both."""
    if window not in _SETUPS:
        jc = dataclasses.replace(jax_config("glm4-9b").reduced(),
                                 dtype="float32", sliding_window=window)
        tc = dataclasses.replace(get_config("glm4-9b").reduced(),
                                 dtype="float32", sliding_window=window)
        jp = jax_init(jc, jax.random.PRNGKey(1))
        _SETUPS[window] = (jc, tc, jp,
                           params_from_numpy(_flatten(jp), device="cpu"))
    return _SETUPS[window]


def _tokens(cfg, b, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, n))


def test_sliding_window_ring_buffer():
    """The twin of the reference's ``test_sliding_window_ring_buffer``:
    decoding every token from a fresh ring of 8 rows equals the forward
    with the same window, and the reference's forward."""
    jc, tc, jp, tp = _setup(8)
    tokens = _tokens(tc, 2, 16, 1)
    want, _ = jax_forward(jc, jp, {"tokens": jnp.asarray(tokens,
                                                         jnp.int32)},
                          remat=False)
    full, _ = forward(tc, tp, {"tokens": torch.as_tensor(tokens)},
                      remat=False)
    cache = init_cache(tc, 2, 16, device="cpu")
    assert cache["units"]["k"].shape[2] == 8
    steps = []
    for t in range(16):
        logits, cache = decode_step(tc, tp, cache,
                                    torch.as_tensor(tokens[:, t:t + 1]))
        steps.append(logits)
    dec = torch.cat(steps, dim=1)
    _close(dec.numpy(), full.detach().numpy())
    _close(full.detach().numpy(), want)


# (window, max_len, prompt length): rings of 8 rows (window 8) and of 10
# (max_len 10 < window 12); prompts shorter than, equal to and past the
# ring, so the decode wraps at different rows
CASES = [(8, 32, 5), (8, 32, 8), (8, 32, 13), (8, 32, 27), (12, 10, 7),
         (12, 10, 23)]


@pytest.mark.parametrize("window,max_len,plen", CASES)
def test_prefill_and_decode_across_the_wrap_match_reference(window,
                                                            max_len, plen):
    jc, tc, jp, tp = _setup(window)
    prompt = _tokens(tc, 2, plen, plen)
    want, jcache = jax_prefill(jc, jp, jax_init_cache(jc, 2, max_len),
                               jnp.asarray(prompt, jnp.int32))
    got, cache = prefill(tc, tp, init_cache(tc, 2, max_len, device="cpu"),
                         torch.as_tensor(prompt))
    rows = min(window, max_len)
    assert cache["units"]["k"].shape == jcache["units"]["k"].shape
    assert cache["units"]["k"].shape[2] == rows
    _close(got.numpy(), want)
    for key in ("k", "v"):
        _close(cache["units"][key].numpy(), jcache["units"][key], err_msg=key)
    toks = _tokens(tc, 2, 2 * rows, plen + 1)
    for t in range(2 * rows):               # twice round the ring
        want, jcache = jax_decode_step(jc, jp, jcache, jnp.asarray(
            toks[:, t:t + 1], jnp.int32))
        got, cache = decode_step(tc, tp, cache,
                                 torch.as_tensor(toks[:, t:t + 1]))
        _close(got.numpy(), want, err_msg=f"step {t}")
    for key in ("k", "v"):
        _close(cache["units"][key].numpy(), jcache["units"][key], err_msg=key)
    assert int(cache["index"]) == int(jcache["index"]) == plen + 2 * rows


@pytest.mark.parametrize("index", [[0, 3], [7, 8], [9, 30], [41, 16]])
def test_attention_decode_on_a_ring_matches_reference(index):
    """One attention block's decode over a ring of 8 rows (window 8) with
    per-example positions: the reference's ring-masked einsum against the
    port's prefix-length decode, output and written rows."""
    rng = np.random.default_rng(sum(index))
    d, h, h_kv, hd, s = 32, 4, 2, 16, 8
    dims = {"wq": (d, h * hd), "wk": (d, h_kv * hd), "wv": (d, h_kv * hd),
            "wo": (h * hd, d)}
    p = {k: {"w": 0.2 * rng.standard_normal(shape, dtype=np.float32)}
         for k, shape in dims.items()}
    x = rng.standard_normal((2, 1, d), dtype=np.float32)
    kv = {k: rng.standard_normal((2, s, h_kv, hd), dtype=np.float32)
          for k in ("k", "v")}
    kw = dict(n_heads=h, n_kv_heads=h_kv, head_dim=hd, window=8)
    idx = np.asarray(index)
    want, wcache = jax_attention_decode(
        p, jnp.asarray(x), None, None, {k: jnp.asarray(v) for k, v in
                                        kv.items()}, jnp.asarray(idx), **kw)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
    got, tcache = attention_decode(
        {k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()},
        torch.from_numpy(x), None, None, tcache, torch.as_tensor(idx), **kw)
    _close(got.numpy(), want, 1e-5)
    for key in ("k", "v"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(wcache[key]))


@pytest.mark.parametrize("s", range(1, 20))
def test_ring_mask_is_the_slot_prefix(s):
    """Every ring of S rows, windows S to S + 5, indices up to 4S + 2: the
    reference's ring mask keeps exactly the rows below min(index + 1, S),
    and the port's ``ring_abs_pos`` is the reference's."""
    idx = np.arange(4 * s + 3)
    for window in range(s, s + 6):
        pos = np.asarray(_ring_abs_pos(jnp.asarray(idx), s))
        valid = (pos <= idx[:, None]) & (pos > idx[:, None] - window) & (
            pos >= 0)
        prefix = np.arange(s)[None, :] < np.minimum(idx + 1, s)[:, None]
        np.testing.assert_array_equal(valid, prefix)
        np.testing.assert_array_equal(
            ref.ring_abs_pos(torch.as_tensor(idx), s).numpy(), pos)


@settings(max_examples=50, deadline=None)
@given(st.integers(1, 300), st.integers(0, 300), st.integers(0, 10_000))
def test_ring_decode_equals_prefix_decode_property(s, extra, index):
    """For any ring of S <= window rows and any position, the reference's
    ring mask (``ref.ring_decode_ref``) and the prefix-length decode the
    kernel runs give the same output (one softmax over the same keys)."""
    window = s + extra
    rng = np.random.default_rng(s * 7919 + index)
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, s, 2, 16), np.float32))
            for _ in range(2))
    idx = torch.tensor([index])
    a = ref.ring_decode_ref(q, k, v, idx, window)
    b = ref.flash_decode_ref(q, k, v, (idx + 1).clamp_max(s))
    _close(a.numpy(), b.numpy(), 1e-5)


def _margin_compare(jc, jp, prompt, want, got, max_len):
    """Tokens equal up to the first step where the reference's top-two
    logit margin is within ``TOL``."""
    n = want.shape[1]
    logits, cache = jax_prefill(jc, jp, jax_init_cache(jc, prompt.shape[0],
                                                       max_len),
                                jnp.asarray(prompt, jnp.int32))
    margins = []
    for t in range(n):
        last = np.sort(np.asarray(logits[:, -1]), axis=-1)
        scale = max(1.0, float(np.abs(last).max()))
        margins.append((last[:, -1] - last[:, -2]) / scale)
        logits, cache = jax_decode_step(
            jc, jp, cache, jnp.asarray(want[:, t:t + 1], jnp.int32))
    margins = np.stack(margins, axis=1)
    compared = 0
    for row in range(prompt.shape[0]):
        close = np.nonzero(margins[row] <= TOL)[0]
        stop = int(close[0]) if close.size else n
        np.testing.assert_array_equal(got[row, :stop], want[row, :stop])
        compared += stop
    return compared


@pytest.mark.parametrize("plen", [6, 19])
def test_generate_and_engine_match_reference_tokens(plen):
    """``generate`` on a ring of 8 rows against the reference's tokens;
    the dense ``DecodeEngine`` on the same requests against solo
    ``generate`` (both scan and eager), token for token."""
    jc, tc, jp, tp = _setup(8)
    prompt = _tokens(tc, 2, plen, 11)
    n, max_len = 14, 16
    want = np.asarray(jax_serve.generate(jc, jp, jnp.asarray(
        prompt, jnp.int32), max_new_tokens=n, max_len=max_len))
    got = serve.generate(tc, tp, torch.as_tensor(prompt), max_new_tokens=n,
                         max_len=max_len).numpy()
    assert _margin_compare(jc, jp, prompt, want, got, max_len) >= n
    eager = serve.generate(tc, tp, torch.as_tensor(prompt),
                           max_new_tokens=n, max_len=max_len,
                           engine="eager").numpy()
    np.testing.assert_array_equal(eager, got)
    eng = DecodeEngine(tc, tp, n_slots=3, max_len=max_len, segment=4)
    rids = [eng.submit(p, n) for p in prompt] + [eng.submit(prompt[0][:3],
                                                            5)]
    out = eng.run()
    for r, p in zip(rids[:2], prompt):
        solo = serve.generate(tc, tp, torch.as_tensor(p)[None, :],
                              max_new_tokens=n, max_len=max_len)[0]
        assert out[r] == solo.tolist()


def test_a_ring_takes_prompts_past_max_len():
    """A linear cache refuses S + new tokens past ``max_len``; a ring
    wraps, in ``generate`` and in the engine's admission."""
    _, tc, _, tp = _setup(8)
    prompt = torch.as_tensor(_tokens(tc, 1, 20, 3))
    toks = serve.generate(tc, tp, prompt, max_new_tokens=6, max_len=8)
    assert toks.shape == (1, 6)
    DecodeEngine(tc, tp, max_len=8, segment=4).submit(prompt[0].numpy(), 9)
    linear = dataclasses.replace(tc, sliding_window=0)
    with pytest.raises(ValueError, match="max_len"):
        serve.generate(linear, tp, prompt, max_new_tokens=6, max_len=8)
