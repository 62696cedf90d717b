"""The port's flash attention on the CPU (its plain PyTorch version behind
the same ``autograd.Function`` the CUDA kernels use) against the
reference's Pallas kernel in interpret mode and its ``jax.grad``.

Inputs come from one numpy seed and go to both packages. Tolerance is the
reference's own for f32 kernel gradients (``_assert_grads_close`` in
``test_kernel_grads.py``): 1e-5 after dividing by max(1, max|reference|),
since the two sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (flash_attention as jax_flash,
                                           flash_attention_fwd as jax_fwd)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
CASES = {"causal": dict(causal=True, window=0),
         "noncausal": dict(causal=False, window=0),
         "window": dict(causal=True, window=48)}


def _close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=tol)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(4)]


def _jax_lse(q, k, v, causal, window):
    """The reference kernel's lse; S padded to its 128 block and masked
    through ``seq_len``, as its padded entry point does."""
    s = q.shape[2]
    sp = -(-s // 128) * 128
    pad = ((0, 0), (0, 0), (0, sp - s), (0, 0))
    qp, kp, vp = (jnp.pad(jnp.asarray(t), pad) for t in (q, k, v))
    _, lse = jax_fwd(qp, kp, vp, causal=causal, window=window,
                     interpret=True, seq_len=s, return_lse=True)
    return np.asarray(lse)[:, :, :s]


@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (2, 2, 256, 32),
                                   (1, 2, 200, 64)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_values_lse_and_grads_match_reference(shape, case):
    kw = CASES[case]
    q, k, v, w = _inputs(shape)

    o_j = jax_flash(*map(jnp.asarray, (q, k, v)), interpret=True, **kw)
    g_j = jax.grad(lambda q, k, v: jnp.sum(jax_flash(
        q, k, v, interpret=True, **kw) * jnp.asarray(w)), (0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))

    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o_t = fa.flash_attention(*leaves, **kw)
    g_t = torch.autograd.grad((o_t * torch.from_numpy(w)).sum(), leaves)
    _, lse_t = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                      **kw)

    _close(o_t.detach(), o_j)
    _close(lse_t, _jax_lse(q, k, v, **kw))
    for got, want in zip(g_t, g_j):
        _close(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_of_plain_forward(case):
    """The dQ and dK/dV plain versions (what the CUDA kernels are held
    against on the card) equal autograd through ``attention_ref``."""
    kw = CASES[case]
    q, k, v, do = map(torch.from_numpy, _inputs((2, 2, 160, 64), seed=1))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = ref.attention_ref(*leaves, **kw)
    g_auto = torch.autograd.grad(o, leaves, do)
    delta = (do * o.detach()).sum(-1)
    dq = ref.attention_bwd_dq_ref(q, k, v, do, lse.detach(), delta, **kw)
    dk, dv = ref.attention_bwd_dkdv_ref(q, k, v, do, lse.detach(), delta,
                                        **kw)
    for got, want in zip((dq, dk, dv), g_auto):
        _close(got, want)


def test_cpu_tensors_never_launch_a_kernel():
    fa.reset_launches()
    q, k, v, w = map(torch.from_numpy, _inputs((1, 96, 2, 64)))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True)
    torch.autograd.grad((out * w).sum(), leaves)
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkdv": 0}


def test_model_layout_entry_matches_kernel_layout():
    """``ops.flash_attention`` takes (B, S, H, D) and returns the same
    values as the (B, H, S, D) kernel entry."""
    q, k, v, _ = map(torch.from_numpy, _inputs((2, 3, 100, 32), seed=2))
    got = ops.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                              causal=True, window=20)
    want, _ = ref.attention_ref(q, k, v, causal=True, window=20)
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("sk,start", [(100, 37), (129, 64), (70, 68)])
def test_suffix_form_matches_reference_full_attention(sk, start):
    """The suffix prefill's form: Sk - start query rows at absolute
    positions start .. Sk - 1 over all Sk keys, against the reference's
    ``full_attention`` with the same ``q_offset`` (model layout)."""
    from repro.models.attention import full_attention as jax_full
    k, v, q_all, _ = _inputs((2, sk, 3, 64), seed=sk)
    q = q_all[:, start:]
    want = jax_full(*map(jnp.asarray, (q, k, v)), causal=True,
                    q_offset=start)
    fa.reset_launches()
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True, q_offset=start)
    assert got.shape == q.shape
    assert fa.LAUNCHES["flash_fwd"] == 0
    _close(got, want)
    # and the same rows of the one-shot form, to the same tolerance
    full = ops.flash_attention(*map(torch.from_numpy, (q_all, k, v)),
                               causal=True)
    _close(got, full[:, start:])


def test_suffix_form_is_forward_only():
    q, k, v, _ = map(torch.from_numpy, _inputs((1, 40, 2, 64), seed=3))
    with pytest.raises(ValueError, match="forward only"):
        ops.flash_attention(q[:, 8:].requires_grad_(True), k, v,
                            q_offset=8)
    with torch.no_grad():
        assert ops.flash_attention(q[:, 8:].requires_grad_(True), k, v,
                                   q_offset=8).shape == (1, 32, 2, 64)
