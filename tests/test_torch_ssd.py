"""The port's Mamba2 SSD on the CPU (its plain PyTorch versions behind the
same wrappers and ``autograd.Function`` the CUDA kernels use) against the
reference's Pallas kernels in interpret mode, its ``jax.grad``, and an f64
sequential oracle.

Inputs come from one numpy seed and go to both packages. Tolerances, all
after dividing by max(1, max|reference|):

- forward, f32: 1e-5. Both run the same chunked algorithm at the same
  chunk in f32 and differ only in summation order.
- forward, bf16 inputs: 2**-7. Both compute in f32 from the same bf16
  inputs and round y to bf16, a relative step of 2**-8; a value near a
  rounding boundary may round the other way. The states stay f32: 1e-5.
- gradients of x, dt, Bm, Cm: 1e-5, the reference's own
  ``_assert_grads_close`` tolerance. The port's chunk is 64, the
  reference's the test's; the chunk changes only the f32 rounding.
- dA: against the f64 oracle, to 1e-4. dA sums B*S products of d(dA)
  and dt of both signs, each d(dA) an in-chunk suffix sum, so f32 keeps
  fewer digits of it than of the other gradients: on these inputs the
  port's f32 path is within 8.4e-6 of the oracle and the reference's own
  kernel within 3.6e-5 at its chunk 256 (why the reference's
  ``test_ssd_grads_chunk_continuity`` fails at 1e-5).
- the plain backward against autograd of the plain forward: 1e-10 in
  f64, the same arithmetic in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan import ssd as jax_ssd
from repro.kernels.mamba2_scan import ssd_fwd as jax_ssd_fwd
from repro_torch.kernels import ops, ref, ssd
from _torch_threads import one_torch_thread  # noqa: F401


def _close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol)


def _inputs(seed, b, s, h, p, n):
    """x, dt = softplus(N - 1), A = -exp(N / 2), Bm, Cm and a cotangent w,
    as the reference's ``_ssd_inputs`` draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h), dtype=np.float32) - 1,
                      0).astype(np.float32)
    a = (-np.exp(rng.standard_normal((h,), dtype=np.float32) * 0.5)
         ).astype(np.float32)
    bm = rng.standard_normal((b, s, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, n), dtype=np.float32)
    w = rng.standard_normal((b, s, h, p), dtype=np.float32)
    return x, dt, a, bm, cm, w


def _torch(arrays, dtype=torch.float32):
    """numpy -> torch; A stays f32 (the kernels' contract)."""
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in arrays)
    return (x.to(dtype), dt.to(dtype), a, bm.to(dtype), cm.to(dtype))


# the reference's forward sweep (tests/test_kernels.py)
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 1, 16, 8, 64), (2, 512, 3, 32, 16, 128),
    (1, 256, 2, 64, 64, 256), (2, 384, 2, 32, 16, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_states_match_reference_kernel(b, s, h, p, n, chunk,
                                                   dtype):
    arrays = _inputs(0, b, s, h, p, n)[:5]
    jd = jnp.dtype(dtype)
    jx, jdt, ja, jb, jc = (jnp.asarray(t) for t in arrays)
    jx, jdt, jb, jc = (t.astype(jd) for t in (jx, jdt, jb, jc))
    y_j, st_j = jax_ssd_fwd(jx, jdt, ja, jb, jc, chunk=chunk,
                            interpret=True, return_states=True)
    y, st = ref.ssd_fwd_ref(*_torch(arrays, getattr(torch, dtype)),
                            chunk=chunk, return_states=True)
    assert y.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    _close(y.float(), np.asarray(y_j, np.float32),
           1e-5 if dtype == "float32" else 2 ** -7)
    _close(st, np.asarray(st_j), 1e-5)


@pytest.mark.parametrize("b,s,h,p,n", [(1, 256, 2, 64, 16),
                                       (2, 100, 3, 32, 8)])
def test_forward_matches_sequential_oracle(b, s, h, p, n):
    """The padded entry at the port's chunk against the f64 recurrence."""
    x, dt, a, bm, cm, _ = _inputs(1, b, s, h, p, n)
    got = ssd.ssd(*_torch((x, dt, a, bm, cm)))
    want = ref.ssd_ref(*(torch.from_numpy(t).double()
                         for t in (x, dt, a, bm, cm)))
    assert got.shape == (b, s, h, p)
    _close(got, want, 1e-5)


# the reference's gradient sweep (tests/test_kernel_grads.py), S = 100 is
# the padded path
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 1, 8, 4, 64), (2, 256, 2, 16, 8, 128),
    (1, 256, 2, 32, 16, 64), (1, 100, 1, 8, 4, 64),
])
def test_grads_match_reference_and_oracle(b, s, h, p, n, chunk):
    x, dt, a, bm, cm, w = _inputs(0, b, s, h, p, n)
    g_j = jax.grad(lambda *t: jnp.sum(jax_ssd(
        *t, chunk=chunk, interpret=True) * w), (0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, dt, a, bm, cm)))
    leaves = [t.requires_grad_(True) for t in _torch((x, dt, a, bm, cm))]
    got = torch.autograd.grad((ssd.ssd(*leaves) * torch.from_numpy(w)).sum(),
                              leaves)
    for i in (0, 1, 3, 4):                     # x, dt, Bm, Cm
        _close(got[i], np.asarray(g_j[i]), 1e-5)
    # dA against the f64 oracle
    leaves64 = [torch.from_numpy(t).double().requires_grad_(True)
                for t in (x, dt, a, bm, cm)]
    g64 = torch.autograd.grad(
        (ref.ssd_ref(*leaves64) * torch.from_numpy(w).double()).sum(),
        leaves64)
    _close(got[2], g64[2], 1e-4)
    for i in (0, 1, 3, 4):
        _close(got[i], g64[i], 1e-5)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_da_is_chunk_independent_against_the_oracle(chunk):
    """The inputs of the reference's ``test_ssd_grads_chunk_continuity``
    shape: the port's plain forward and backward at several chunks, each
    held against the f64 oracle (not against another chunk at 1e-5)."""
    x, dt, a, bm, cm, w = _inputs(1, 1, 256, 2, 8, 8)
    args = _torch((x, dt, a, bm, cm))
    y, states = ref.ssd_fwd_ref(*args, chunk=chunk, return_states=True)
    raw = ref.ssd_bwd_ref(*args, states, torch.from_numpy(w), chunk=chunk)
    got = ssd.combine_grads(*args, raw)
    leaves64 = [torch.from_numpy(t).double().requires_grad_(True)
                for t in (x, dt, a, bm, cm)]
    want = torch.autograd.grad(
        (ref.ssd_ref(*leaves64) * torch.from_numpy(w).double()).sum(),
        leaves64)
    _close(got[2], want[2], 1e-4)
    for i in (0, 1, 3, 4):
        _close(got[i], want[i], 1e-5)


@pytest.mark.parametrize("chunk", [32, 64])
def test_plain_backward_equals_autograd_of_plain_forward(chunk):
    """``ssd_bwd_ref`` (the kernel's math) and the chain rule outside it
    give autograd's gradients of ``ssd_fwd_ref``, in f64."""
    x, dt, a, bm, cm, w = _inputs(2, 2, 128, 3, 16, 8)
    leaves = [torch.from_numpy(t).double().requires_grad_(True)
              for t in (x, dt, a, bm, cm)]
    dy = torch.from_numpy(w).double()
    y, states = ref.ssd_fwd_ref(*leaves, chunk=chunk, return_states=True)
    want = torch.autograd.grad((y * dy).sum(), leaves)
    args = [t.detach() for t in leaves]
    got = ssd.combine_grads(*args, ref.ssd_bwd_ref(
        *args, states.detach(), dy, chunk=chunk))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float64
        _close(g, wnt, 1e-10)


def test_cpu_tensors_never_launch_a_kernel():
    ssd.reset_launches()
    x, dt, a, bm, cm, w = _inputs(3, 1, 100, 2, 64, 16)
    leaves = [t.requires_grad_(True) for t in _torch((x, dt, a, bm, cm))]
    y = ops.ssd(*leaves)
    torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    with torch.no_grad():
        ops.ssd(*leaves)
    assert ssd.LAUNCHES == {"ssd_fwd": 0, "ssd_bwd": 0}


def test_other_devices_raise():
    x = torch.empty((1, 64, 2, 64), device="meta")
    dt = torch.empty((1, 64, 2), device="meta")
    bm = torch.empty((1, 64, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        ssd.ssd_fwd(x, dt, torch.empty(2, device="meta"), bm, bm)


@pytest.mark.parametrize("shape,dtype,error", [
    ((1, 64, 2, 32, 16), torch.float32, ValueError),     # P = 32
    ((1, 64, 2, 64, 32), torch.float32, ValueError),     # N = 32
    ((1, 100, 2, 64, 16), torch.float32, ValueError),    # S not padded
    ((1, 64, 2, 64, 16), torch.float16, TypeError),
])
def test_kernel_check_refuses_what_the_kernels_do_not_take(shape, dtype,
                                                           error):
    """The checks a CUDA tensor meets before a launch, on CPU tensors."""
    b, s, h, p, n = shape
    x = torch.zeros((b, s, h, p), dtype=dtype)
    dt = torch.zeros((b, s, h), dtype=dtype)
    bm = torch.zeros((b, s, n), dtype=dtype)
    with pytest.raises(error):
        ssd._check("ssd_fwd", x, dt, torch.zeros(h), bm, bm)


def test_kernel_check_refuses_mismatched_operands():
    x = torch.zeros((1, 64, 2, 64))
    dt, bm = torch.zeros((1, 64, 2)), torch.zeros((1, 64, 16))
    assert ssd._check("ssd_fwd", x, dt, torch.zeros(2), bm, bm) == (
        1, 64, 2, 64, 16)
    with pytest.raises(ValueError, match="A is"):
        ssd._check("ssd_fwd", x, dt, torch.zeros(2, dtype=torch.bfloat16),
                   bm, bm)
    with pytest.raises(ValueError, match="contiguous"):
        ssd._check("ssd_fwd", x, dt, torch.zeros(2), bm,
                   torch.zeros((1, 16, 64)).transpose(1, 2))
    with pytest.raises(ValueError, match="states is"):
        ssd._check("ssd_bwd", x, dt, torch.zeros(2), bm, bm,
                   states=torch.zeros((1, 2, 2, 64, 16)), dy=x)
