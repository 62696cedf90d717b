"""The family check: the twin of ``tests/test_arch_smoke.py`` over all
ten architectures of the reference, run through the port. Each reduced
config in f32 takes one forward (shapes, finite logits and aux) and one
accumulated train step (finite loss and gradient norm, the parameters
moved); its parameter count equals the reference's, reduced (both
initialised) and at full size (the port's on ``meta`` against the
reference's ``jax.eval_shape``). The weight bridge carries the last two
families' checkpoint keys both ways.

Then the twin of ``examples/serve_batched.py``: glm4-9b with a window
of 16 (a ring buffer), xlstm-1.3b (O(1) state), zamba2-7b (hybrid) and
whisper-tiny (encoder-decoder) through the port's ``generate``: the
scan and eager loops give the same tokens, bit for bit, and the
prefill's logits are the reference's to 1e-4 after dividing by
max(1, max|reference|) (``test_torch_model.py``'s logits tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.npz import _flatten
from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import param_count as jax_param_count
from repro.models import prefill as jax_prefill
from repro.models.model import prefill_cache_whisper as jax_cache_whisper
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import make_batch
from repro_torch.launch import serve
from repro_torch.models import (forward, init_cache, init_params,
                                param_count, prefill)
from repro_torch.models.model import prefill_cache_whisper
from repro_torch.train import TrainConfig, adamw_init, make_train_step
from repro_torch.tree import flatten
from _torch_threads import one_torch_thread  # noqa: F401

B, S = 2, 64


def reduced(name, **kw):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32",
                               **kw)


def test_the_port_has_every_architecture():
    assert ARCH_NAMES == JAX_ARCH_NAMES and len(ARCH_NAMES) == 10


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_reduced_constraints(name):
    cfg = reduced(name)
    assert cfg.n_layers <= max(2, cfg.pattern_unit())
    assert cfg.d_model <= 512
    assert cfg.moe_experts <= 4


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_shapes_and_finite(name):
    cfg = reduced(name)
    params = init_params(cfg, 0, device="cpu")
    batch = make_batch(cfg, B, S, device="cpu")
    with torch.no_grad():
        logits, aux = forward(cfg, params, batch)
    assert logits.shape == (B, S, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), name
    assert bool(torch.isfinite(aux))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_step_no_nans(name):
    cfg = reduced(name)
    params = init_params(cfg, 0, device="cpu")
    before = {k: t.clone() for k, t in flatten(params).items()}
    batch = make_batch(cfg, B, S, device="cpu")
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainConfig(accum_steps=2))
    params, opt, metrics = step(params, opt, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert opt.step == 1
    assert any(not torch.equal(t, before[k])
               for k, t in flatten(params).items()), name


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_count_matches_reference(name):
    cfg = reduced(name)
    jc = dataclasses.replace(jax_config(name).reduced(), dtype="float32")
    assert param_count(init_params(cfg, 0, device="cpu")) == \
        jax_param_count(jax_init(jc, jax.random.PRNGKey(0)))
    full = param_count(init_params(get_config(name), 0, device="meta"))
    shapes = jax.eval_shape(lambda: jax_init(jax_config(name),
                                             jax.random.PRNGKey(0)))
    assert full == sum(int(np.prod(x.shape))
                       for x in jax.tree.leaves(shapes))


# the keys under which the reference's npz checkpoints hold the last two
# families' weights, as ``checkpoint/npz._flatten`` writes them
LAST_FAMILY_KEYS = {
    "xlstm-1.3b": ["units/mlstm/mlstm/in_proj/w", "units/mlstm/ln/scale",
                   "units/slstm/slstm/r", "units/slstm/slstm/b",
                   "units/slstm/slstm/w_in/w"],
    "whisper-tiny": ["encoder/units/attn/wq/w", "encoder/units/mlp/up/b",
                     "encoder/ln_f/scale", "units/xattn/wk/w",
                     "units/lnx/scale", "units/mlp/up/b", "units/mlp/down/b"],
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(LAST_FAMILY_KEYS))
def test_bridge_carries_the_last_families(name, dtype):
    """The reference's flattened weights cross into the port and back
    bit for bit, bf16 leaves as their raw bits, under the reference's
    keys (the mLSTM stack (n_units, u - 1, ...), the sLSTM's r (n_units,
    H, Dh, 4 Dh), the encoder's stack by ``encoder_layers``)."""
    jc = dataclasses.replace(jax_config(name).reduced(), dtype=dtype)
    flat = _flatten(jax_init(jc, jax.random.PRNGKey(3)))
    params = params_from_numpy(flat, device="cpu")
    got = flatten(params)
    assert sorted(got) == sorted(flat)
    for key in LAST_FAMILY_KEYS[name]:
        assert tuple(got[key].shape) == flat[key].shape, key
    back = params_to_numpy(params)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key],
                                      np.asarray(arr, dtype=np.float32))
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    assert {k: tuple(v.shape) for k, v in flatten(
        init_params(cfg, 0, device="cpu")).items()} == {
        k: v.shape for k, v in flat.items()}


# ---------------------------------------------------------------------- #
# the twin of examples/serve_batched.py
# ---------------------------------------------------------------------- #
SERVED = [("glm4-9b", dict(sliding_window=16)), ("xlstm-1.3b", {}),
          ("zamba2-7b", {}), ("whisper-tiny", {})]


@pytest.mark.parametrize("name,kw", SERVED, ids=[n for n, _ in SERVED])
def test_serve_batched_across_cache_families(name, kw):
    cfg = reduced(name, **kw)
    jc = dataclasses.replace(jax_config(name).reduced(), dtype="float32",
                             **kw)
    jp = jax_init(jc, jax.random.PRNGKey(0))
    params = params_from_numpy(_flatten(jp), device="cpu")
    rng = np.random.default_rng(0)
    b, plen, new, max_len = 4, 8, 12, 64
    prompt = rng.integers(0, cfg.vocab, (b, plen))
    frames = None
    if cfg.is_encoder_decoder:
        frames = (rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
                  * 0.02).astype(np.float32)
        jcache = jax_cache_whisper(jc, jp, jnp.asarray(frames), b, max_len)
        cache = prefill_cache_whisper(cfg, params, torch.from_numpy(frames),
                                      b, max_len)
    else:
        jcache = jax_init_cache(jc, b, max_len)
        cache = init_cache(cfg, b, max_len, device="cpu")
    want, _ = jax_prefill(jc, jp, jcache, jnp.asarray(prompt, jnp.int32))
    got, _ = prefill(cfg, params, cache, torch.from_numpy(prompt))
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               atol=1e-4, rtol=1e-4)
    gen = dict(max_new_tokens=new, max_len=max_len,
               frames=None if frames is None else torch.from_numpy(frames))
    scan = serve.generate(cfg, params, torch.from_numpy(prompt),
                          engine="scan", **gen)
    eager = serve.generate(cfg, params, torch.from_numpy(prompt),
                           engine="eager", **gen)
    assert scan.shape == (b, new)
    torch.testing.assert_close(scan, eager, rtol=0, atol=0)
