"""The port's dense/vlm model against the reference at reduced size:
configs, batches, the weight bridge, and forward logits.

Logits are compared in f32 (both configs with ``dtype="float32"``) to
1e-4 after dividing by max(1, max|reference|): the two frameworks round
the same f32 arithmetic (matmuls, RMS norm, RoPE tables, softmax) in
different orders through a few layers and a vocab-wide head, which keeps
them a few ulps apart, well inside 1e-4."""
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
from repro.models import param_count as jax_param_count
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.models import forward, init_params, param_count
from repro_torch.tree import flatten
from _torch_threads import one_torch_thread  # noqa: F401

MODELS = ["minicpm-2b", "qwen2-vl-2b"]


def _configs(name):
    jc = dataclasses.replace(jax_config(name).reduced(), dtype="float32")
    tc = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    return jc, tc


@pytest.mark.parametrize("name", MODELS)
def test_configs_match_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jax_config(name))
    assert dataclasses.asdict(get_config(name).reduced()) == \
        dataclasses.asdict(jax_config(name).reduced())


def test_unported_families_name_their_slice():
    with pytest.raises(NotImplementedError, match="hybrid slice"):
        get_config("zamba2-7b")
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                              family="moe")
    with pytest.raises(NotImplementedError, match="remaining-families"):
        init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("step,seed", [(0, 0), (3, 7)])
def test_batches_identical(name, step, seed):
    jc, tc = _configs(name)
    jb = jax_batch(jc, 3, 40, step=step, seed=seed)
    tb = make_batch(tc, 3, 40, step=step, seed=seed, device="cpu")
    assert sorted(jb) == sorted(tb)
    for key in jb:
        np.testing.assert_array_equal(np.asarray(jb[key]), tb[key].numpy())


@pytest.mark.parametrize("name", MODELS)
def test_init_layout_matches_reference(name):
    jc, tc = _configs(name)
    jp = jax_init(jc, jax.random.PRNGKey(0))
    params = init_params(tc, 0, device="cpu")
    want = {k: v.shape for k, v in _flatten(jp).items()}
    got = {k: tuple(v.shape) for k, v in flatten(params).items()}
    assert got == want
    assert param_count(params) == jax_param_count(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    jc = dataclasses.replace(jax_config("qwen2-vl-2b").reduced(),
                             dtype=dtype)
    flat = _flatten(jax_init(jc, jax.random.PRNGKey(1)))
    params = params_from_numpy(flat, device="cpu")
    assert flatten(params)["embed/table"].dtype == getattr(torch, dtype)
    back = params_to_numpy(params)
    assert sorted(back) == sorted(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key],
                                      np.asarray(arr, dtype=np.float32))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("batch,seq,seed", [(2, 48, 3), (1, 37, 5)])
def test_forward_logits_match_reference(name, batch, seq, seed):
    jc, tc = _configs(name)
    jp = jax_init(jc, jax.random.PRNGKey(0))
    params = params_from_numpy(_flatten(jp), device="cpu")
    jb = jax_batch(jc, batch, seq, seed=seed)
    tb = make_batch(tc, batch, seq, seed=seed, device="cpu")
    want, _ = jax_forward(jc, jp, jb)
    got, aux = forward(tc, params, tb)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy() / scale, want / scale,
                               atol=1e-4, rtol=1e-4)
    assert float(aux) == 0.0


def test_remat_does_not_change_the_forward():
    _, tc = _configs("minicpm-2b")
    params = init_params(tc, 0, device="cpu")
    batch = make_batch(tc, 2, 32, device="cpu")
    a, _ = forward(tc, params, batch, remat=True)
    b, _ = forward(tc, params, batch, remat=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("causal,window,n_kv_heads", [
    (True, 0, 4), (True, 40, 4), (False, 0, 4), (True, 0, 2)])
def test_attention_matches_reference(causal, window, n_kv_heads):
    """The port's attention block (projections, RoPE, GQA repeat, and the
    attention core through ``ops.flash_attention``, its plain version on
    the CPU) against the reference's ``attention`` on its plain path, on
    f32 weights and inputs from one numpy seed. Tolerance 1e-5 after
    dividing by max(1, max|reference|): one layer of f32 arithmetic
    summed in different orders."""
    from repro.models.attention import attention as jax_attention
    from repro.models.layers import rope_cos_sin as jax_rope
    from repro_torch.models.attention import attention
    from repro_torch.models.layers import rope_cos_sin
    rng = np.random.default_rng(5)
    d, h, hd, s = 48, 4, 16, 96
    dims = {"wq": (d, h * hd), "wk": (d, n_kv_heads * hd),
            "wv": (d, n_kv_heads * hd), "wo": (h * hd, d)}
    p = {k: {"w": 0.2 * rng.standard_normal(shape, dtype=np.float32)}
         for k, shape in dims.items()}
    x = rng.standard_normal((2, s, d), dtype=np.float32)
    kw = dict(n_heads=h, n_kv_heads=n_kv_heads, head_dim=hd, causal=causal,
              window=window)
    cos, sin = jax_rope(jax.numpy.arange(s), hd, 10000.0)
    want = np.asarray(jax_attention(p, x, cos, sin, **kw))
    tp = {k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()}
    tcos, tsin = rope_cos_sin(torch.arange(s), hd, 10000.0)
    got = attention(tp, torch.from_numpy(x), tcos, tsin, **kw)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy() / scale, want / scale,
                               atol=1e-5, rtol=1e-5)
