"""The port's flash decode on the CPU (the plain PyTorch versions behind
``ops.flash_decode`` / ``ops.flash_decode_paged``) against the reference's
Pallas decode kernels, called directly in interpret mode.

Inputs come from one numpy seed and go to both packages. The reference
takes the kv heads repeated to H and q as (B, H, 1, D); the port takes
the cache with its kv heads once and q in model layout. Tolerances, after
dividing by max(1, max|reference|): f32 1e-5 (the same f32 arithmetic
summed in different orders); bf16 2**-7 (both compute in f32 from the
same bf16 inputs and round the result to bf16, one rounding step of
2**-8 apart at most, and the limit is two).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jax_decode
from repro.kernels.flash_decode import flash_decode_paged as jax_paged
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref
from _torch_threads import one_torch_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=TOL[dtype],
                               rtol=TOL[dtype])


def _arrays(rng, dtype, *shapes):
    """f32 numpy arrays, rounded through the working dtype once, so both
    packages see the same values."""
    jdt, _ = DTYPES[dtype]
    return [np.array(jnp.asarray(rng.standard_normal(s, dtype=np.float32),
                                 jdt).astype(jnp.float32))
            for s in shapes]


def _torch(arr, dtype):
    return torch.from_numpy(arr).to(DTYPES[dtype][1])


def _jax(arr, dtype):
    return jnp.asarray(arr, DTYPES[dtype][0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,h_kv,s,d", [
    (3, 4, 4, 96, 32),      # MHA, S under the reference's 128 block
    (4, 4, 2, 200, 16),     # GQA 2:1, ragged S
    (2, 6, 1, 130, 32),     # GQA 6:1
])
def test_flash_decode_matches_reference_kernel(dtype, b, h, h_kv, s, d):
    rng = np.random.default_rng(s)
    q, k, v = _arrays(rng, dtype, (b, 1, h, d), (b, s, h_kv, d),
                      (b, s, h_kv, d))
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    lengths[0] = 0                      # an empty slot gives 0
    lengths[-1] = s
    groups = h // h_kv
    kr, vr = (np.repeat(t, groups, axis=2).transpose(0, 2, 1, 3)
              for t in (k, v))
    want = jax_decode(_jax(q.transpose(0, 2, 1, 3), dtype), _jax(kr, dtype),
                      _jax(vr, dtype), jnp.asarray(lengths), interpret=True)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    got = ops.flash_decode(_torch(q, dtype), _torch(k, dtype),
                           _torch(v, dtype), torch.from_numpy(lengths))
    assert got.dtype == DTYPES[dtype][1] and got.shape == q.shape
    assert float(got[0].abs().max()) == 0.0
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("h,h_kv,ps", [(4, 2, 8), (6, 1, 16), (4, 4, 8)])
def test_flash_decode_paged_matches_reference_kernel(dtype, h, h_kv, ps):
    rng = np.random.default_rng(ps + h)
    b, d, p_tab, n_pg = 4, 32, 5, 23
    q, kp, vp = _arrays(rng, dtype, (b, 1, h, d), (n_pg, ps, h_kv, d),
                        (n_pg, ps, h_kv, d))
    lengths = np.array([0, 1, 2 * ps + 3, p_tab * ps], np.int32)
    # a shuffled pool; -1 past each slot's length
    free = list(rng.permutation(n_pg))
    pages = np.full((b, p_tab), -1, np.int32)
    for i in range(b):
        for j in range(-(-int(lengths[i]) // ps)):
            pages[i, j] = free.pop()
    want = jax_paged(_jax(q.transpose(0, 2, 1, 3), dtype), _jax(kp, dtype),
                     _jax(vp, dtype), jnp.asarray(pages),
                     jnp.asarray(lengths), interpret=True)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    got = ops.flash_decode_paged(_torch(q, dtype), _torch(kp, dtype),
                                 _torch(vp, dtype), torch.from_numpy(pages),
                                 torch.from_numpy(lengths))
    assert float(got[0].abs().max()) == 0.0
    _close(got.float().numpy(), want, dtype)


def test_paged_plain_equals_linear_plain_bitwise():
    """The gather the paged plain version does reproduces the linear
    cache's result bit for bit (the engine's paged == dense identity on
    the CPU rests on it)."""
    rng = np.random.default_rng(3)
    b, h, h_kv, d, ps, p_tab = 3, 4, 2, 16, 8, 4
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d), np.float32))
    dense = torch.from_numpy(
        rng.standard_normal((2, b, p_tab * ps, h_kv, d), np.float32))
    pool = torch.zeros((2, b * p_tab + 1, ps, h_kv, d))
    lengths = torch.tensor([5, 17, 32])
    pages = torch.full((b, p_tab), -1, dtype=torch.int32)
    order = rng.permutation(b * p_tab)
    for i in range(b):
        for j in range(-(-int(lengths[i]) // ps)):
            pg = int(order[i * p_tab + j])
            pages[i, j] = pg
            pool[:, pg] = dense[:, i, j * ps:(j + 1) * ps]
    lin = ops.flash_decode(q, dense[0], dense[1], lengths)
    pag = ops.flash_decode_paged(q, pool[0], pool[1], pages, lengths)
    assert torch.equal(lin, pag)


def test_lengths_past_the_cache_are_clamped():
    """An idle engine slot's length can run past the cache: the valid set
    is then the whole cache, as in the reference's mask."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 1, 2, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 16),
                                                 np.float32))
            for _ in range(2))
    a = ops.flash_decode(q, k, v, torch.tensor([24, 24]))
    c = ops.flash_decode(q, k, v, torch.tensor([40, 1000]))
    assert torch.equal(a, c)


def test_decode_is_the_last_row_of_causal_attention():
    """Decoding position n-1 against n cached keys equals row n-1 of the
    plain causal attention over those n positions."""
    rng = np.random.default_rng(2)
    b, h, s, d = 2, 2, 32, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d),
                                                    np.float32))
               for _ in range(3))
    full, _ = ref.attention_ref(q, k, v, causal=True)
    for n in (1, 7, 32):
        out = ops.flash_decode(q[:, :, n - 1:n].transpose(1, 2),
                               k.transpose(1, 2), v.transpose(1, 2),
                               torch.full((b,), n))
        torch.testing.assert_close(out[:, 0], full[:, :, n - 1],
                                   rtol=1e-5, atol=1e-5)


def test_cpu_route_counts_no_launch_and_other_devices_raise():
    fd.reset_launches()
    q = torch.zeros((1, 1, 2, 64))
    k = torch.zeros((1, 8, 2, 64))
    ops.flash_decode(q, k, k, torch.tensor([3]))
    ops.flash_decode_paged(q, k, k, torch.zeros((1, 1), dtype=torch.int32),
                           torch.tensor([3]))
    assert fd.LAUNCHES == {"flash_decode": 0, "flash_decode_paged": 0}
    qm = torch.zeros((1, 1, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no flash-attention path"):
        fd.flash_decode(qm, qm, qm, torch.tensor([1]))
