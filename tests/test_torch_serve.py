"""The port's serving path against the reference at reduced size in f32,
with the reference's weights carried across by ``checkpoint.bridge``:
prefill logits and cache, teacher-forced decode logits, and greedy
tokens; and, inside the port, scan == eager generation.

Logits and cache rows are compared to 1e-4 after dividing by
max(1, max|reference|), as ``test_torch_model.py`` compares forward
logits: the two frameworks round the same f32 arithmetic in different
orders through a few layers and a vocab-wide head. Greedy tokens must
agree up to the first step whose top-two logit margin (of the reference,
teacher-forced on its own tokens) is within that tolerance; after a near
tie the two may pick differently, and the comparison stops there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.npz import _flatten
from repro.configs import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill, prefill_extend)
from _torch_threads import one_torch_thread  # noqa: F401

MODELS = ["minicpm-2b", "qwen2-vl-2b"]
TOL = 1e-4
MAX_LEN = 32


def _close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol)


_SETUPS = {}


def _setup(name):
    """Reference and port configs and the same f32 weights in both."""
    if name not in _SETUPS:
        jc = dataclasses.replace(jax_config(name).reduced(), dtype="float32")
        tc = dataclasses.replace(get_config(name).reduced(), dtype="float32")
        jp = jax_init(jc, jax.random.PRNGKey(0))
        _SETUPS[name] = (jc, tc, jp,
                         params_from_numpy(_flatten(jp), device="cpu"))
    return _SETUPS[name]


def _prompt(cfg, batch, plen, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, plen))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("batch,plen,seed", [(2, 12, 0), (1, 21, 3)])
def test_prefill_logits_and_cache_match_reference(name, batch, plen, seed):
    jc, tc, jp, tp = _setup(name)
    prompt = _prompt(jc, batch, plen, seed)
    want, jcache = jax_prefill(jc, jp, jax_init_cache(jc, batch, MAX_LEN),
                               jnp.asarray(prompt, jnp.int32))
    got, cache = prefill(tc, tp, init_cache(tc, batch, MAX_LEN,
                                            device="cpu"),
                         torch.as_tensor(prompt))
    assert got.shape == want.shape
    _close(got.numpy(), want)
    assert int(cache["index"]) == int(jcache["index"]) == plen
    for key in ("k", "v"):
        assert tuple(cache["units"][key].shape) == jcache["units"][key].shape
        _close(cache["units"][key].numpy(), jcache["units"][key])


@pytest.mark.parametrize("name", MODELS)
def test_prefill_equals_forward_inside_the_port(name):
    _, tc, _, tp = _setup(name)
    tokens = torch.as_tensor(_prompt(tc, 2, 12, 1))
    full, _ = forward(tc, tp, {"tokens": tokens}, remat=False)
    logits, _ = prefill(tc, tp, init_cache(tc, 2, MAX_LEN, device="cpu"),
                        tokens)
    torch.testing.assert_close(logits, full, rtol=0, atol=0)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("per_slot", [False, True])
def test_teacher_forced_decode_logits_match_reference(name, per_slot):
    """After a prefill, feed the same tokens to both ``decode_step``s, one
    position at a time; ``per_slot`` passes a per-example index vector
    (the engine's form) instead of the cache's scalar."""
    jc, tc, jp, tp = _setup(name)
    prompt = _prompt(jc, 2, 9, 5)
    feed = _prompt(jc, 2, 6, 6)
    _, jcache = jax_prefill(jc, jp, jax_init_cache(jc, 2, MAX_LEN),
                            jnp.asarray(prompt, jnp.int32))
    _, cache = prefill(tc, tp, init_cache(tc, 2, MAX_LEN, device="cpu"),
                       torch.as_tensor(prompt))
    for t in range(feed.shape[1]):
        kw_j, kw_t = {}, {}
        if per_slot:
            kw_j = {"index": jnp.full((2,), 9 + t, jnp.int32)}
            kw_t = {"index": torch.full((2,), 9 + t)}
        want, jcache = jax_decode_step(
            jc, jp, jcache, jnp.asarray(feed[:, t:t + 1], jnp.int32), **kw_j)
        got, cache = decode_step(tc, tp, cache,
                                 torch.as_tensor(feed[:, t:t + 1]), **kw_t)
        _close(got.numpy(), want)
    _close(cache["units"]["k"].numpy(), jcache["units"]["k"])


@pytest.mark.parametrize("name", MODELS)
def test_greedy_tokens_match_reference_up_to_a_near_tie(name):
    jc, tc, jp, tp = _setup(name)
    prompt = _prompt(jc, 2, 12, 0)
    n = 16
    want = np.asarray(jax_serve.generate(jc, jp, jnp.asarray(prompt,
                                                             jnp.int32),
                                         max_new_tokens=n, max_len=MAX_LEN))
    got = serve.generate(tc, tp, torch.as_tensor(prompt), max_new_tokens=n,
                         max_len=MAX_LEN).numpy()
    assert got.shape == want.shape == (2, n)
    # the reference's top-two margin at each step, on its own tokens
    logits, cache = jax_prefill(jc, jp, jax_init_cache(jc, 2, MAX_LEN),
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
    for row in range(2):
        close = np.nonzero(margins[row] <= TOL)[0]
        stop = int(close[0]) if close.size else n
        np.testing.assert_array_equal(got[row, :stop], want[row, :stop])
        compared += stop
    assert compared >= n            # a near tie is rare, not the rule


@pytest.mark.parametrize("name", MODELS)
def test_scan_equals_eager_inside_the_port(name):
    _, tc, _, tp = _setup(name)
    prompt = torch.as_tensor(_prompt(tc, 2, 10, 2))
    common = dict(max_new_tokens=8, max_len=MAX_LEN)
    scan = serve.generate(tc, tp, prompt, engine="scan", **common)
    eager = serve.generate(tc, tp, prompt, engine="eager", **common)
    assert torch.equal(scan, eager)
    # and with seeded sampling: the same generator draws in the same order
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]
    s = serve.generate(tc, tp, prompt, engine="scan", greedy=False,
                       generator=gens[0], **common)
    e = serve.generate(tc, tp, prompt, engine="eager", greedy=False,
                       generator=gens[1], **common)
    assert torch.equal(s, e)


@pytest.mark.parametrize("name", MODELS)
def test_per_token_prefill_gives_the_one_shot_tokens(name):
    """The reference's baseline pair: per-token prefill + eager loop ==
    one-shot prefill + device loop."""
    _, tc, _, tp = _setup(name)
    prompt = torch.as_tensor(_prompt(tc, 2, 12, 0))
    common = dict(max_new_tokens=8, max_len=MAX_LEN)
    a = serve.generate(tc, tp, prompt, engine="eager",
                       prefill_mode="per_token", **common)
    b = serve.generate(tc, tp, prompt, engine="scan",
                       prefill_mode="one_shot", **common)
    assert torch.equal(a, b)


def test_cache_index_advances_and_overflow_raises():
    _, tc, _, tp = _setup("minicpm-2b")
    cache = init_cache(tc, 2, 16, device="cpu")
    assert int(cache["index"]) == 0
    logits, cache = decode_step(tc, tp, cache,
                                torch.zeros((2, 1), dtype=torch.long))
    assert int(cache["index"]) == 1
    assert logits.shape == (2, 1, tc.vocab)
    # the reference clamps this write silently; the port refuses it
    with pytest.raises(ValueError, match="max_len"):
        serve.generate(tc, tp, torch.zeros((1, 10), dtype=torch.long),
                       max_new_tokens=7, max_len=16)


def test_sliding_window_cache_raises():
    """A windowed config decodes over a ring buffer: ``init_cache``,
    ``prefill`` and ``decode_step`` take it, and what the reference
    refuses a window (``init_paged_cache``, ``prefill_extend``, and so
    the paged engine) raises, naming the linear layout it needs."""
    from repro_torch.launch.engine import DecodeEngine
    from repro_torch.models import init_paged_cache
    tc = dataclasses.replace(get_config("minicpm-2b").reduced(),
                             dtype="float32", sliding_window=8)
    params = init_params(tc, 1, device="cpu")
    cache = init_cache(tc, 2, 16, device="cpu")
    assert cache["units"]["k"].shape[2] == 8
    tokens = torch.zeros((2, 4), dtype=torch.long)
    _, cache = prefill(tc, params, cache, tokens)
    _, cache = decode_step(tc, params, cache, tokens[:, :1])
    assert int(cache["index"]) == 5
    with pytest.raises(ValueError, match="linear"):
        init_paged_cache(tc, 2, 16, page_size=8, n_pages=4, device="cpu")
    with pytest.raises(ValueError, match="linear"):
        prefill_extend(tc, params, cache, tokens, start=2)
    with pytest.raises(ValueError, match="linear"):
        DecodeEngine(tc, params, paged=True, max_len=16, page_size=8)


def test_main_runs_on_the_cpu(capsys):
    toks = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--tokens", "4"])
    assert toks.shape == (2, 4)
    assert "generated (2, 4)" in capsys.readouterr().out
