"""The port's whisper-tiny (the audio family) against the reference at
reduced size, in f32: sinusoidal positions and the GELU MLP, the
encoder, the decoder's forward logits and the gradients of every leaf
(the encoder's among them), the cross K/V cache from frames shorter than
``encoder_seq``, prefill and decode; inside the port, decode == forward,
paged == dense and scan == eager, bitwise; and the rectangular flash
attention (decoder rows over encoder rows, Sk != Sq, non-causal) with
its backward, which the cross-attention takes on the card, against
``jax.grad`` of the reference's plain attention.

The reduced config is the reference's ``reduced()``: 2 encoder and 2
decoder layers, d_model 256, 4 heads of 64, encoder_seq 64. Weights
cross by ``params_from_numpy``; inputs come from numpy seeds.
Tolerances, after dividing by max(1, max|reference|): logits 1e-4,
states, gradients and one function's outputs 1e-5
(``test_torch_families.py``'s).
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
from repro.models import init_params as jax_init
from repro.models import layers as jax_layers
from repro.models import param_count as jax_param_count
from repro.models import prefill as jax_prefill
from repro.models.attention import full_attention as jax_full_attention
from repro.models.model import encode as jax_encode
from repro.models.model import prefill_cache_whisper as jax_cache_whisper
from repro.train.train_step import loss_fn as jax_loss_fn
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode, ops, ref
from repro_torch.launch import serve
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import (decode_step, forward, init_cache,
                                init_paged_cache, init_params, param_count,
                                prefill)
from repro_torch.models import layers
from repro_torch.models.model import encode, prefill_cache_whisper
from repro_torch.train import (TrainConfig, accumulate_gradients,
                               make_loss_and_grad)
from repro_torch.tree import flatten, grad_leaves
from _torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL, TOL = 1e-4, 1e-5
NAME = "whisper-tiny"


def _close(got, want, tol=TOL, err_msg=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               rtol=tol, err_msg=err_msg)


def _configs():
    jc = dataclasses.replace(jax_config(NAME).reduced(), dtype="float32")
    tc = dataclasses.replace(get_config(NAME).reduced(), dtype="float32")
    return jc, tc


@functools.lru_cache(maxsize=None)
def _bridged(seed=0):
    jc, tc = _configs()
    jp = jax_init(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(_flatten(jp), device="cpu")


def _frames(tc, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, tc.d_model), dtype=np.float32) * 0.02


# ---------------------------------------------------------------------- #
# layers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [384, 256])
def test_sinusoidal_positions_match_reference(d):
    """To 1e-5 over the reduced config's positions (up to 64 frames, 48
    tokens). At Whisper's 1500 frames the two frameworks' f32 ``exp`` of
    a frequency may differ by an ulp (2**-24 relative), which position p
    turns into an angle apart by up to p * 2**-23: the bound held there."""
    want = jax_layers.sinusoidal_positions(jnp.arange(100), d)
    got = layers.sinusoidal_positions(torch.arange(100), d)
    assert got.dtype == torch.float32 and got.shape == (100, d)
    _close(got, np.asarray(want))
    pos = np.array([[0, 1, 7, 447], [1499, 3, 2, 100]])
    want = np.asarray(jax_layers.sinusoidal_positions(jnp.asarray(pos), d))
    got = layers.sinusoidal_positions(torch.as_tensor(pos), d).numpy()
    assert (np.abs(got - want) <= pos[..., None] * 2.0 ** -23 + 1e-6).all()


def test_gelu_mlp_takes_the_tanh_form_and_biases():
    rng = np.random.default_rng(0)
    p = {"up": {"w": rng.standard_normal((16, 40), dtype=np.float32) * 0.3,
                "b": rng.standard_normal(40, dtype=np.float32)},
         "down": {"w": rng.standard_normal((40, 16), dtype=np.float32) * 0.3,
                  "b": rng.standard_normal(16, dtype=np.float32)}}
    x = rng.standard_normal((3, 5, 16), dtype=np.float32) * 2
    want = jax_layers.gelu_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in p.items()}
    got = layers.gelu_mlp(tp, torch.from_numpy(x))
    _close(got, np.asarray(want))
    exact = layers.linear(tp["down"], torch.nn.functional.gelu(
        layers.linear(tp["up"], torch.from_numpy(x))))
    assert float((exact - got).abs().max()) > 1e-5     # not the erf form
    init = layers.gelu_mlp_init(torch.Generator().manual_seed(0), 16, 40,
                                lead=(3,), dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten(init).items()} == {
        "down/b": (3, 16), "down/w": (3, 40, 16), "up/b": (3, 40),
        "up/w": (3, 16, 40)}


# ---------------------------------------------------------------------- #
# the rectangular flash attention and its backward
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sq,sk", [(37, 150), (96, 64), (448, 1500)])
def test_rectangular_backward_matches_jax_grad(sq, sk):
    """Decoder rows over encoder rows, non-causal: the plain forward, dQ
    and dK/dV (the kernels' plain versions) against ``jax.grad`` of the
    reference's ``full_attention(causal=False)``, and
    ``ops.flash_attention``'s gradient the same (on the CPU the
    autograd.Function takes the plain versions)."""
    rng = np.random.default_rng(sq)
    b, h, d = (1, 2, 64) if sk > 1000 else (2, 3, 64)
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, sk, h, d), dtype=np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    out, vjp = jax.vjp(lambda q, k, v: jax_full_attention(
        q, k, v, causal=False), *map(jnp.asarray, (q, k, v)))
    want = (np.asarray(out),) + tuple(np.asarray(g) for g in vjp(
        jnp.asarray(do)))
    qt, kt, vt, dot = (torch.from_numpy(t).transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    o, lse = ref.attention_ref(qt, kt, vt, causal=False)
    delta = (dot * o).sum(dim=-1)
    dq = fa.flash_attention_bwd_dq(qt, kt, vt, dot, lse, delta,
                                   causal=False)
    dk, dv = fa.flash_attention_bwd_dkdv(qt, kt, vt, dot, lse, delta,
                                         causal=False)
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                            want):
        _close(got.transpose(1, 2), w, err_msg=name)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out_t = ops.flash_attention(*leaves, causal=False)
    grads = torch.autograd.grad(out_t, leaves, torch.from_numpy(do))
    for name, got, w in zip(("o", "dq", "dk", "dv"),
                            (out_t.detach(),) + grads, want):
        _close(got, w, err_msg=f"ops {name}")
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkdv": 0}


def test_causal_rectangular_attention_stays_forward_only():
    q = torch.zeros((1, 5, 2, 64), requires_grad=True)
    k = torch.zeros((1, 9, 2, 64), requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        ops.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="forward only"):
        ops.flash_attention(q, q, q, causal=False, q_offset=2)
    with torch.no_grad():
        assert ops.flash_attention(q, k, k, causal=True).shape == q.shape


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
    assert got["encoder/units/mlp/up/b"][0] == (tc.encoder_layers, tc.d_ff)
    assert got["units/xattn/wk/w"][0] == (tc.n_units, 256, 256)


def test_batch_carries_the_reference_frames():
    jc, tc = _configs()
    jb = jax_batch(jc, 3, 20, step=2, seed=4)
    tb = make_batch(tc, 3, 20, step=2, seed=4, device="cpu")
    assert sorted(jb) == sorted(tb) == ["frames", "labels", "tokens"]
    for key in jb:
        np.testing.assert_array_equal(np.asarray(jb[key]), tb[key].numpy())
    assert tb["frames"].shape == (3, tc.encoder_seq, tc.d_model)


@pytest.mark.parametrize("se", [64, 40])
def test_encode_matches_reference(se):
    jc, tc, jp, params = _bridged()
    frames = _frames(tc, 2, se, se)
    want = jax_encode(jc, jp, jnp.asarray(frames))
    with torch.no_grad():
        got = encode(tc, params, torch.from_numpy(frames))
    _close(got, np.asarray(want))


@pytest.mark.parametrize("batch,seq,seed", [(2, 48, 3), (1, 37, 5)])
def test_forward_logits_match_reference(batch, seq, seed):
    jc, tc, jp, params = _bridged()
    jb = jax_batch(jc, batch, seq, seed=seed)
    tb = make_batch(tc, batch, seq, seed=seed, device="cpu")
    want, _ = jax_forward(jc, jp, jb)
    got, aux = forward(tc, params, tb)
    _close(got.detach(), np.asarray(want), LOGIT_TOL)
    assert float(aux) == 0.0


def test_loss_and_gradients_of_every_leaf_match_reference():
    """The encoder's leaves among them: its stack is split into one
    gradient leaf per encoder layer, by its own leading dimension."""
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
        _close(got[key], want[key], err_msg=key)
    split, slots = grad_leaves(params)
    assert len(split["encoder"]["units"]) == tc.encoder_layers
    assert [i for k, i, _ in slots if k == "encoder/units/attn/wq/w"] == [
        (u,) for u in range(tc.encoder_layers)]
    assert [i for k, i, _ in slots if k == "encoder/ln_f/scale"] == [None]


@pytest.mark.parametrize("batch,accum", [(4, 2), (5, 3)])
def test_accumulated_equals_full_batch(batch, accum):
    """``test_torch_train.py``'s identity and tolerances; the frames are
    split with the tokens."""
    _, tc = _configs()
    params = init_params(tc, 0, device="cpu")
    data = make_batch(tc, batch, 24, device="cpu")
    lg = make_loss_and_grad(tc, TrainConfig())
    loss_full, g_full = accumulate_gradients(lg, params, data, 1)
    loss_acc, g_acc = accumulate_gradients(lg, params, data, accum)
    torch.testing.assert_close(loss_acc, loss_full, rtol=1e-5, atol=1e-6)
    fa_, ff = flatten(g_acc), flatten(g_full)
    assert sorted(fa_) == sorted(flatten(params))
    for key in ff:
        torch.testing.assert_close(fa_[key], ff[key], rtol=5e-4, atol=5e-6)


def _whisper_caches(se, b=2, max_len=32, seed=0):
    jc, tc, jp, params = _bridged()
    frames = _frames(tc, b, se, seed)
    jcache = jax_cache_whisper(jc, jp, jnp.asarray(frames), b, max_len)
    cache = prefill_cache_whisper(tc, params, torch.from_numpy(frames), b,
                                  max_len)
    return jc, tc, jp, params, jcache, cache


@pytest.mark.parametrize("se", [40, 64])
def test_prefill_and_decode_match_reference(se):
    """Frames shorter than encoder_seq (40 of 64 rows: ``cross_len`` 40,
    the rest of the cross K/V zero) and as long: the cross K/V, the
    prefill's logits and self K/V, then 6 teacher-forced decode steps
    fed the reference's greedy token."""
    jc, tc, jp, params, jcache, cache = _whisper_caches(se)
    assert cache["cross_len"] == int(jcache["cross_len"]) == se
    for key in ("k", "v"):
        _close(cache["units"]["cross"][key],
               np.asarray(jcache["units"]["cross"][key]), err_msg=key)
    assert not cache["units"]["cross"]["k"][:, :, se:].any()
    prompt = np.random.default_rng(9).integers(0, tc.vocab, (2, 11))
    jlogits, jcache = jax_prefill(jc, jp, jcache,
                                  jnp.asarray(prompt, jnp.int32))
    logits, cache = prefill(tc, params, cache, torch.from_numpy(prompt))
    _close(logits, np.asarray(jlogits), LOGIT_TOL, "prefill logits")
    for key in ("k", "v"):
        _close(cache["units"]["self"][key],
               np.asarray(jcache["units"]["self"][key]), err_msg=key)
    jstep = jax.jit(functools.partial(jax_decode_step, jc))
    tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    for step in range(6):
        jlogits, jcache = jstep(jp, jcache, jnp.asarray(tok, jnp.int32))
        logits, cache = decode_step(tc, params, cache, torch.from_numpy(tok))
        _close(logits, np.asarray(jlogits), LOGIT_TOL, f"decode {step}")
        tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    assert flash_decode.LAUNCHES == {"flash_decode": 0,
                                     "flash_decode_paged": 0}


def test_decode_equals_forward():
    """Inside the port: a prefill of 10 tokens and 14 decode steps give
    the teacher-forced forward's logits at every position."""
    _, tc, _, params = _bridged()
    batch = make_batch(tc, 2, 24, seed=6, device="cpu")
    with torch.no_grad():
        want, _ = forward(tc, params, batch)
    toks = batch["tokens"]
    cache = prefill_cache_whisper(tc, params, batch["frames"], 2, 32)
    logits, cache = prefill(tc, params, cache, toks[:, :10])
    got = [logits]
    for t in range(10, 24):
        logits, cache = decode_step(tc, params, cache, toks[:, t:t + 1])
        got.append(logits)
    _close(torch.cat(got, dim=1), want.numpy(), LOGIT_TOL)


def paged_from_dense(cfg, dense, page_size):
    """A paged cache holding a dense cache's rows: slot b's self K/V rows
    in pool pages b * P .. b * P + P - 1 (P = max_len / page_size), the
    cross K/V and ``cross_len`` as they are."""
    b, max_len = dense["units"]["self"]["k"].shape[1:3]
    p_tab = max_len // page_size
    paged = init_paged_cache(cfg, b, max_len, page_size=page_size,
                             n_pages=b * p_tab, device="cpu")
    for key in ("k", "v"):
        rows = dense["units"]["self"][key]          # (U, B, max_len, H, D)
        paged["units"]["self"][key][:, :b * p_tab] = rows.reshape(
            (rows.shape[0], b * p_tab, page_size) + rows.shape[3:])
        paged["units"]["cross"][key].copy_(dense["units"]["cross"][key])
    paged["pages"].copy_(torch.arange(b * p_tab, dtype=torch.int32)
                         .reshape(b, p_tab))
    paged["index"] = dense["index"].clone()
    paged["cross_len"] = dense["cross_len"]
    return paged


def test_paged_decode_equals_dense_and_scan_equals_eager():
    """Inside the port, bitwise: decode over a paged self K/V (the cross
    K/V stays dense per slot) == over the dense cache; ``generate``'s
    scan == its eager loop; the engine refuses an encoder-decoder."""
    _, tc, _, params = _bridged()
    frames = torch.from_numpy(_frames(tc, 2, 50, 1))
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab, (2, 7)))
    dense = prefill_cache_whisper(tc, params, frames, 2, 32)
    _, dense = prefill(tc, params, dense, prompt)
    paged = paged_from_dense(tc, dense, 8)
    assert paged["units"]["self"]["k"].shape[1:3] == (2 * 4 + 1, 8)
    assert paged["units"]["cross"]["k"].shape[1:3] == (2, tc.encoder_seq)
    tok = prompt[:, -1:]
    for _ in range(5):
        ld, dense = decode_step(tc, params, dense, tok)
        lp, paged = decode_step(tc, params, paged, tok)
        torch.testing.assert_close(lp, ld, rtol=0, atol=0)
        tok = torch.argmax(ld[:, -1:], dim=-1)
    kw = dict(max_new_tokens=6, max_len=32, frames=frames)
    scan = serve.generate(tc, params, prompt, engine="scan", **kw)
    eager = serve.generate(tc, params, prompt, engine="eager", **kw)
    torch.testing.assert_close(scan, eager, rtol=0, atol=0)
    with pytest.raises(ValueError, match="frames"):
        serve.generate(tc, params, prompt, max_new_tokens=2, max_len=32)
    with pytest.raises(ValueError, match="max_len"):
        serve.generate(tc, params, prompt, max_new_tokens=30, max_len=32,
                       frames=frames)
    with pytest.raises(ValueError, match="encoder-decoder"):
        DecodeEngine(tc, params, n_slots=2, max_len=32)


def test_serve_main_makes_the_frames(capsys):
    toks = serve.main(["--arch", "whisper-tiny", "--reduced", "--device",
                       "cpu", "--batch", "2", "--tokens", "3"])
    assert toks.shape == (2, 3)
    assert "arch=whisper-tiny-reduced" in capsys.readouterr().out


def test_fresh_cache_layout_matches_reference():
    jc, tc = _configs()
    from repro.models import init_cache as jax_init_cache
    jcache = jax_init_cache(jc, 3, 16)
    cache = init_cache(tc, 3, 16, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten(cache["units"]).items()} \
        == {k: v.shape for k, v in _flatten(jcache["units"]).items()}
    assert cache["cross_len"] == 0
