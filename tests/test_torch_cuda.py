"""The CUDA kernels against their plain versions on the card. Needs an
NVIDIA GPU with ``nvcc``; marked ``cuda`` and skipped without one. Run
on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``."""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _err(got, want):
    """Largest per-row relative error, as ``chip_smoke.py`` holds the
    kernels: over the rows of the last axis (each lse entry a row of
    one), ||got - want|| / max(||want||, median row norm)."""
    g, w = got.float(), want.float()
    cols = w.shape[-1] if w.dim() == 4 else 1
    g, w = g.reshape(-1, cols), w.reshape(-1, cols)
    norm = w.norm(dim=1)
    return float(((g - w).norm(dim=1)
                  / torch.maximum(norm, norm.median())).max())


# chip_smoke.py's limits: f32 summation order; two bf16 rounding steps
@pytest.mark.parametrize("shape,dtype,causal,window,tol", [
    ((1, 4, 1000, 128), torch.float32, True, 0, 1e-5),
    ((2, 2, 320, 64), torch.float32, False, 0, 1e-5),
    ((1, 4, 512, 64), torch.bfloat16, True, 100, 2 ** -7),
])
def test_kernels_match_plain(cuda, shape, dtype, causal, window, tol):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
                   for _ in range(4))
    kw = dict(causal=causal, window=window)
    fa.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o_r, lse_r = ref.attention_ref(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq_r = ref.attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    dk_r, dv_r = ref.attention_bwd_dkdv_ref(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkdv": 1}
    for got, want in ((o, o_r), (lse, lse_r), (dq, dq_r), (dk, dk_r),
                      (dv, dv_r)):
        assert _err(got, want) <= tol


def test_wrong_head_dim_raises(cuda):
    q = torch.zeros((1, 1, 64, 32), device=cuda)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_fwd(q, q, q)


def test_model_attention_on_the_card_takes_the_kernels(cuda):
    """No switch: attention on CUDA tensors launches the kernels."""
    from repro_torch.models.attention import attention
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    d, h, hd, s = 128, 2, 64, 96
    p = {k: {"w": 0.05 * torch.randn(shape, generator=gen, device=cuda)}
         for k, shape in (("wq", (d, h * hd)), ("wk", (d, h * hd)),
                          ("wv", (d, h * hd)), ("wo", (h * hd, d)))}
    x = torch.randn((1, s, d), generator=gen, device=cuda,
                    requires_grad=True)
    fa.reset_launches()
    attention(p, x, None, None, n_heads=h, n_kv_heads=h,
              head_dim=hd).sum().backward()
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkdv": 1}
