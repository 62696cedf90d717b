"""The four passes of the port's SSD kernels on the CPU: the plain versions
of the forward state pass, forward chunk pass, backward state pass and
backward chunk pass (``kernels/ref.py``), each behind the wrapper that
launches its kernel on the card. Held against the port's own one-pass
plain versions, the reference's Pallas kernels in interpret mode and an
f64 sequential oracle.

Inputs come from one numpy seed and go to both packages. Tolerances, all
after dividing by max(1, max|reference|):

- composed passes against ``ssd_fwd_ref`` / ``ssd_bwd_ref`` in f64:
  1e-10. The same arithmetic, with the chunks folded into the batch and
  the state recurrence run on its own.
- states and y against the reference's ``ssd_fwd`` in f32: 1e-5, as
  ``tests/test_torch_ssd.py`` holds ``ssd_fwd_ref``. Both run the chunked
  scan at chunk 64 in f32 and differ only in summation order.
- gradients of x, dt, Bm and Cm against the reference's ``ssd_bwd`` given
  the same states and dy: 1e-5, the reference's own gradient tolerance.
- dA against the f64 oracle: 1e-4. dA sums B S products of d(dA) and dt
  of both signs, so f32 keeps fewer of its digits (``test_torch_ssd.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mamba2_scan import ssd as jax_ssd
from repro.kernels.mamba2_scan import ssd_bwd as jax_ssd_bwd
from repro.kernels.mamba2_scan import ssd_fwd as jax_ssd_fwd
from repro_torch.kernels import ref, ssd
from _torch_threads import one_torch_thread  # noqa: F401

CHUNK = ssd.CHUNK


def _close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol)


def _inputs(seed, b, s, h, p, n):
    """x, dt = softplus(N - 1), A = -exp(N / 2), Bm, Cm and a cotangent
    dy, as the reference's ``_ssd_inputs`` draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h), dtype=np.float32) - 1,
                      0).astype(np.float32)
    a = (-np.exp(rng.standard_normal((h,), dtype=np.float32) * 0.5)
         ).astype(np.float32)
    bm = rng.standard_normal((b, s, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, n), dtype=np.float32)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    return x, dt, a, bm, cm, dy


def _torch(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(t).to(dtype) for t in arrays)


def _passes(x, dt, a, bm, cm, dy):
    """The four passes through their wrappers (the CPU route): states, y,
    d(states) and the raw backward."""
    states = ssd.fwd_state(x, dt, a, bm)
    y = ssd.fwd_chunk(x, dt, a, bm, cm, states)
    dstates = ssd.bwd_state(dt, a, cm, dy)
    raw = ssd.bwd_chunk(x, dt, a, bm, cm, states, dstates, dy)
    return states, y, dstates, raw


SHAPES = [(1, 128, 2, 8, 8), (2, 192, 3, 16, 32), (1, 256, 2, 64, 16),
          (2, 384, 2, 32, 64)]


@pytest.mark.parametrize("b,s,h,p,n", SHAPES)
def test_composed_passes_equal_the_one_pass_plain_versions(b, s, h, p, n):
    """State pass then chunk pass == ``ssd_fwd_ref`` and ``ssd_bwd_ref``,
    in f64."""
    x, dt, a, bm, cm, dy = _torch(_inputs(0, b, s, h, p, n), torch.float64)
    states, y, dstates, raw = _passes(x, dt, a, bm, cm, dy)
    y_want, st_want = ref.ssd_fwd_ref(x, dt, a, bm, cm, chunk=CHUNK,
                                      return_states=True)
    assert states.shape == (b, h, s // CHUNK, p, n) == dstates.shape
    _close(states, st_want, 1e-10)
    _close(y, y_want, 1e-10)
    for got, want in zip(raw, ref.ssd_bwd_ref(x, dt, a, bm, cm, st_want, dy,
                                              chunk=CHUNK)):
        assert got.dtype == want.dtype == torch.float64
        _close(got, want, 1e-10)


def test_dstates_are_the_gradient_of_each_chunks_output_state():
    """The backward state pass's d(states)[c] is d(loss)/d(the state leaving
    chunk c), in f64: with d_in[c] the gradient of the state entering chunk
    c through that chunk's y alone (autograd through the chunk pass), the
    state leaving chunk c enters chunk c + 1 and is carried on with the
    factor exp(total_{c+1}); the last chunk's leaves the sequence (0)."""
    b, s, h = 1, 256, 2
    x, dt, a, bm, cm, dy = _torch(_inputs(1, b, s, h, 16, 8), torch.float64)
    states = ssd.fwd_state(x, dt, a, bm).requires_grad_(True)
    y = ssd.fwd_chunk(x, dt, a, bm, cm, states)
    (d_in,) = torch.autograd.grad((y * dy).sum(), states)
    nc = s // CHUNK
    total = (a * dt).reshape(b, nc, CHUNK, h).sum(dim=2)         # (b,nc,h)
    want = torch.zeros_like(d_in)
    for c in reversed(range(nc - 1)):
        et = torch.exp(total[:, c + 1])[..., None, None]
        want[:, :, c] = d_in[:, :, c + 1] + et * want[:, :, c + 1]
    _close(ssd.bwd_state(dt, a, cm, dy), want, 1e-10)


@pytest.mark.parametrize("b,s,h,p,n", SHAPES)
def test_forward_passes_match_reference_kernel(b, s, h, p, n):
    """States from the state pass and y from the chunk pass against the
    reference's Pallas forward at chunk 64 in interpret mode, f32."""
    arrays = _inputs(2, b, s, h, p, n)[:5]
    y_j, st_j = jax_ssd_fwd(*map(jnp.asarray, arrays), chunk=CHUNK,
                            interpret=True, return_states=True)
    x, dt, a, bm, cm = _torch(arrays)
    states = ssd.fwd_state(x, dt, a, bm)
    y = ssd.fwd_chunk(x, dt, a, bm, cm, states)
    assert states.dtype == torch.float32 and y.dtype == torch.float32
    _close(states, np.asarray(st_j), 1e-5)
    _close(y, np.asarray(y_j), 1e-5)


@pytest.mark.parametrize("b,s,h,p,n", SHAPES)
def test_backward_passes_match_reference_kernel_and_oracle(b, s, h, p, n):
    """The backward state pass, the chunk pass and ``combine_grads`` against
    the reference's Pallas backward at chunk 64 in interpret mode, given
    the same states and dy; dA against the f64 oracle."""
    arrays = _inputs(3, b, s, h, p, n)
    jx, jdt, ja, jb, jc, jdy = map(jnp.asarray, arrays)
    _, st_j = jax_ssd_fwd(jx, jdt, ja, jb, jc, chunk=CHUNK, interpret=True,
                          return_states=True)
    g_j = jax_ssd_bwd(jx, jdt, ja, jb, jc, st_j, jdy, chunk=CHUNK,
                      interpret=True)
    x, dt, a, bm, cm, dy = _torch(arrays)
    states = torch.from_numpy(np.array(st_j))
    dstates = ssd.bwd_state(dt, a, cm, dy)
    got = ssd.combine_grads(x, dt, a, bm, cm, ssd.bwd_chunk(
        x, dt, a, bm, cm, states, dstates, dy))
    for i in (0, 1, 3, 4):                     # x, dt, Bm, Cm
        _close(got[i], np.asarray(g_j[i]), 1e-5)
    leaves = [torch.from_numpy(t).double().requires_grad_(True)
              for t in arrays[:5]]
    g64 = torch.autograd.grad(
        (ref.ssd_ref(*leaves) * torch.from_numpy(arrays[5]).double()).sum(),
        leaves)
    _close(got[2], g64[2], 1e-4)


@pytest.mark.parametrize("s", [100, 200, 333])
def test_ragged_s_through_ssd_matches_the_passes_and_reference(s):
    """``ssd.ssd`` at a ragged S (padded with dt = 0 to the chunk): y and
    every gradient against the passes run on the padded inputs and cut
    back, y against the reference's ``ssd`` at chunk 64."""
    arrays = _inputs(4, 2, s, 3, 16, 8)
    x, dt, a, bm, cm, dy = _torch(arrays)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm)]
    y = ssd.ssd(*leaves)
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    y = y.detach()
    pad = -s % CHUNK
    xp, dyp = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
    dtp, bp, cp = (F.pad(t, (0, 0, 0, pad)) for t in (dt, bm, cm))
    _, y_p, _, raw = _passes(xp, dtp, a, bp, cp, dyp)
    g_p = ssd.combine_grads(xp, dtp, a, bp, cp, raw)
    _close(y, y_p[:, :s], 1e-6)
    for g, w in zip(grads, g_p):
        _close(g, w[:, :s] if w.dim() > 1 else w, 1e-6)
    y_j = jax_ssd(*map(jnp.asarray, arrays[:5]), chunk=CHUNK,
                  interpret=True)
    _close(y, np.asarray(y_j), 1e-5)


def test_passes_never_count_as_launches():
    """Only ``ssd_fwd`` and ``ssd_bwd`` count, and only on the card."""
    ssd.reset_launches()
    _passes(*_torch(_inputs(5, 1, 128, 2, 64, 16)))
    assert ssd.LAUNCHES == {"ssd_fwd": 0, "ssd_bwd": 0}


def test_kernel_check_takes_dstates_and_refuses_misaligned_tiles():
    """The checks a CUDA tensor meets before a pass launches, on CPU
    tensors: d(states) has the states' shape, and tiles that come in by
    16-byte copies are 16-byte aligned (dt and A need not be)."""
    x = torch.zeros((1, 64, 2, 64))
    dt, bm = torch.zeros((1, 64, 2)), torch.zeros((1, 64, 16))
    st = torch.zeros((1, 2, 1, 64, 16))
    dims = ssd._check("bwd_chunk", x, dt, torch.zeros(2), bm, bm, states=st,
                      dstates=st, dy=x)
    assert dims == (1, 64, 2, 64, 16)
    with pytest.raises(ValueError, match="dstates is"):
        ssd._check("bwd_chunk", x, dt, torch.zeros(2), bm, bm, states=st,
                   dstates=st[:, :1], dy=x)
    shifted = torch.zeros(64 * 16 + 1)[1:].reshape(1, 64, 16)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd._check("fwd_state", x, dt, torch.zeros(2), shifted, shifted)
    dt_shifted = torch.zeros(128 + 1)[1:].reshape(1, 64, 2)
    assert ssd._check("fwd_state", x, dt_shifted, torch.zeros(2), bm,
                      bm) == dims
