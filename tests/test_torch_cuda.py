"""The CUDA kernels against their plain versions on the card. Needs an
NVIDIA GPU with ``nvcc``; marked ``cuda`` and skipped without one. Run
on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.kernels import ssd
from repro_torch.launch.engine import DecodeEngine
from repro_torch.models import init_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _err(got, want):
    """Largest per-row relative error, as ``chip_smoke.py`` holds the
    kernels: over the rows of the last axis (each lse entry a row of
    one), ||got - want|| / max(||want||, median nonzero row norm)."""
    g, w = got.float(), want.float()
    cols = w.shape[-1] if w.dim() == 4 else 1
    g, w = g.reshape(-1, cols), w.reshape(-1, cols)
    norm = w.norm(dim=1)
    floor = norm[norm > 0].median() if bool((norm > 0).any()) else 1.0
    return float(((g - w).norm(dim=1)
                  / torch.clamp_min(norm, floor)).max())


# chip_smoke.py's limits: f32 summation order; two bf16 rounding steps
@pytest.mark.parametrize("shape,dtype,causal,window,tol", [
    ((1, 4, 1000, 128), torch.float32, True, 0, 1e-5),
    ((2, 2, 320, 64), torch.float32, False, 0, 1e-5),
    ((1, 4, 512, 64), torch.bfloat16, True, 100, 2 ** -7),
    ((1, 4, 1000, 112), torch.float32, True, 0, 1e-5),
    ((1, 8, 512, 112), torch.bfloat16, True, 0, 2 ** -7),
    # the bf16 tensor-core forward and dK/dV at the same edges
    ((1, 4, 1000, 64), torch.bfloat16, True, 0, 2 ** -7),
    ((1, 4, 1000, 112), torch.bfloat16, True, 0, 2 ** -7),
    ((1, 4, 1000, 128), torch.bfloat16, True, 0, 2 ** -7),
    ((2, 2, 320, 64), torch.bfloat16, False, 0, 2 ** -7),
    ((1, 4, 1000, 64), torch.bfloat16, True, 200, 2 ** -7),
    # stablelm-12b's head_dim 160 (the bf16 dK/dV spills there)
    ((1, 4, 1000, 160), torch.float32, True, 0, 1e-5),
    ((2, 2, 320, 160), torch.float32, False, 0, 1e-5),
    ((1, 4, 1000, 160), torch.float32, True, 200, 1e-5),
    ((1, 4, 1000, 160), torch.bfloat16, True, 0, 2 ** -7),
    ((2, 2, 320, 160), torch.bfloat16, False, 0, 2 ** -7),
    ((1, 4, 1000, 160), torch.bfloat16, True, 200, 2 ** -7),
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


# Whisper's cross-attention: decoder rows over encoder rows (Sk != Sq),
# non-causal, forward and backward; a ragged Sq and one with Sq > Sk
@pytest.mark.parametrize("b,h,sq,sk,dtype,tol", [
    (2, 6, 448, 1500, torch.bfloat16, 2 ** -7),
    (2, 6, 448, 1500, torch.float32, 1e-5),
    (2, 3, 37, 1500, torch.float32, 1e-5),
    (2, 3, 37, 1500, torch.bfloat16, 2 ** -7),
    (1, 4, 300, 130, torch.float32, 1e-5),
    (1, 4, 300, 130, torch.bfloat16, 2 ** -7),
])
def test_rectangular_kernels_match_plain(cuda, b, h, sq, sk, dtype, tol):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)

    def rand(s):
        return torch.randn((b, h, s, 64), generator=gen,
                           device=cuda).to(dtype)
    q, do, k, v = rand(sq), rand(sq), rand(sk), rand(sk)
    kw = dict(causal=False)
    fa.reset_launches()
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    o_r, lse_r = ref.attention_ref(q, k, v, **kw)
    dq_r = ref.attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    dk_r, dv_r = ref.attention_bwd_dkdv_ref(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkdv": 1}
    assert dk.shape == k.shape and dq.shape == q.shape
    for got, want in ((o, o_r), (lse, lse_r), (dq, dq_r), (dk, dk_r),
                      (dv, dv_r)):
        assert _err(got, want) <= tol


def test_cross_decode_matches_plain(cuda):
    """One decoder token over 1500 cached encoder rows, all valid and a
    prefix of them, at Whisper's 6 heads of 64."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    for dtype, tol in ((torch.bfloat16, 2 ** -7), (torch.float32, 1e-5)):
        q = torch.randn((4, 1, 6, 64), generator=gen, device=cuda).to(dtype)
        k, v = (torch.randn((4, 1500, 6, 64), generator=gen, device=cuda)
                .to(dtype) for _ in range(2))
        for n in (1500, 1024):
            lengths = torch.full((4,), n, dtype=torch.int32, device=cuda)
            got = fd.flash_decode(q, k, v, lengths)
            want = ref.flash_decode_ref(q, k, v, lengths)
            torch.cuda.synchronize()
            assert _err(got, want) <= tol


# the bf16 dQ kernel (tensor cores) against the plain backward at each
# head_dim, ragged, non-causal and windowed; and the whole function
# (kernels, delta in torch) against the same composition of plain
# versions, where dQ's dS = P (dP - delta) cancels
@pytest.mark.parametrize("d", [64, 112, 128, 160])
@pytest.mark.parametrize("shape,causal,window", [
    ((1, 4, 1000), True, 0),
    ((2, 2, 320), False, 0),
    ((1, 4, 1000), True, 200),
])
def test_bf16_dq_matches_plain(cuda, d, shape, causal, window):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    q, k, v, do = (torch.randn((*shape, d), generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    fa.reset_launches()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dq_r = ref.attention_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves,
                                do)
    o_r, lse_r = ref.attention_ref(q, k, v, **kw)
    delta_r = (do.float() * o_r.float()).sum(-1)
    plain = (ref.attention_bwd_dq_ref(q, k, v, do, lse_r, delta_r, **kw),
             *ref.attention_bwd_dkdv_ref(q, k, v, do, lse_r, delta_r, **kw))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dq"] == 2
    assert dq.dtype == torch.bfloat16
    assert _err(dq, dq_r) <= 2 ** -7
    for got, want in zip(grads, plain):
        assert _err(got, want) <= 2 ** -7


@pytest.mark.parametrize("sk,start,d,dtype,tol", [
    (1000, 333, 128, torch.float32, 1e-5),
    (777, 700, 64, torch.bfloat16, 2 ** -7),
    (130, 64, 64, torch.float32, 1e-5),
    (1000, 333, 64, torch.bfloat16, 2 ** -7),
    (1000, 333, 128, torch.bfloat16, 2 ** -7),
    (1000, 333, 160, torch.float32, 1e-5),
    (1000, 333, 160, torch.bfloat16, 2 ** -7),
])
def test_forward_at_a_query_offset(cuda, sk, start, d, dtype, tol):
    """The suffix prefill's form (Sk - start query rows at absolute
    positions start ..) against the plain version, and bitwise equal to
    the same rows of the one-shot forward over all Sk rows."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    q, k, v = (torch.randn((2, 3, sk, d), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    qs = q[:, :, start:].contiguous()
    fa.reset_launches()
    o, lse = fa.flash_attention_fwd(qs, k, v, causal=True, q_offset=start)
    o_full, lse_full = fa.flash_attention_fwd(q, k, v, causal=True)
    o_r, lse_r = ref.attention_ref(qs, k, v, causal=True, q_offset=start)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == 2
    assert _err(o, o_r) <= tol and _err(lse, lse_r) <= tol
    assert torch.equal(o, o_full[:, :, start:])
    assert torch.equal(lse, lse_full[:, :, start:])


def test_wrong_head_dim_raises(cuda):
    q = torch.zeros((1, 1, 64, 32), device=cuda)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_fwd(q, q, q)


def test_misaligned_input_raises(cuda):
    """The kernels copy rows 16 bytes at a time: a contiguous view that
    starts off a 16-byte boundary is refused, not read askew."""
    flat = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    q = flat[1:].view(1, 1, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
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


def _decode_inputs(gen, b, h, h_kv, s, d, dtype, page_size=16, lengths=None):
    """q, linear k/v, ragged lengths (unless given: one 0, one past the
    cache), and the same rows in a shuffled pool with -1 past each
    length."""
    dev = gen.device
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, h_kv, d), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    if lengths is None:
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
        lengths[0], lengths[-1] = 0, s + 7
    p_tab = -(-s // page_size)
    n_pg = b * p_tab + 2
    perm = torch.randperm(n_pg, generator=gen, device=dev)
    pages = torch.full((b, p_tab), -1, dtype=torch.int32, device=dev)
    pools = [torch.zeros((n_pg, page_size, h_kv, d), dtype=dtype,
                         device=dev) for _ in range(2)]
    for i in range(b):
        n = min(int(lengths[i]), s)
        for j in range(-(-n // page_size)):
            pg = int(perm[i * p_tab + j])
            pages[i, j] = pg
            rows = slice(j * page_size, min((j + 1) * page_size, s))
            width = rows.stop - rows.start
            pools[0][pg, :width] = k[i, rows]
            pools[1][pg, :width] = v[i, rows]
    return q, k, v, lengths, pools, pages


# chip_smoke.py's limits, on the per-row error over each (b, head) row
@pytest.mark.parametrize("b,h,h_kv,s,d,dtype,tol", [
    (4, 36, 36, 1000, 64, torch.bfloat16, 2 ** -7),
    (4, 12, 2, 777, 128, torch.bfloat16, 2 ** -7),
    (3, 4, 2, 333, 128, torch.float32, 1e-5),
    (3, 6, 1, 77, 64, torch.float32, 1e-5),
    (2, 6, 1, 77, 64, torch.bfloat16, 2 ** -7),
    # zamba2's shared block: 32 MHA heads of 112, and GQA at 112
    (4, 32, 32, 1000, 112, torch.bfloat16, 2 ** -7),
    (4, 32, 32, 1000, 112, torch.float32, 1e-5),
    (3, 8, 2, 333, 112, torch.float32, 1e-5),
    (3, 8, 2, 333, 112, torch.bfloat16, 2 ** -7),
    # stablelm-12b: 32 heads of 160 over 8 kv heads (f32: two 16-byte
    # loads a lane)
    (4, 32, 8, 1000, 160, torch.bfloat16, 2 ** -7),
    (4, 32, 8, 1000, 160, torch.float32, 1e-5),
])
def test_decode_kernels_match_plain(cuda, b, h, h_kv, s, d, dtype, tol):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    q, k, v, lengths, (kp, vp), pages = _decode_inputs(gen, b, h, h_kv, s,
                                                       d, dtype)
    fd.reset_launches()
    out = fd.flash_decode(q, k, v, lengths)
    out_p = fd.flash_decode_paged(q, kp, vp, pages, lengths)
    g = h // h_kv
    want = ref.flash_decode_ref(q, k.repeat_interleave(g, 2),
                                v.repeat_interleave(g, 2), lengths)
    want_p = ref.flash_decode_paged_ref(q, kp, vp, pages, lengths)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == {"flash_decode": 1, "flash_decode_paged": 1}
    assert float(out[0].abs().max()) == 0.0     # length 0 gives 0
    rows = slice(1, None)                       # rows with a valid key
    assert _err(out[rows], want[rows]) <= tol
    assert _err(out_p[rows], want_p[rows]) <= tol
    # the same rows through the table: the same bits, by construction.
    # A length past S counts S rows of the linear cache but the table's
    # ceil(S / 16) pages, so only slots that fit the cache compare.
    fits = lengths <= s
    assert not fits.all()
    assert torch.equal(out[fits], out_p[fits])


# each split the autotuner may choose, at every head dim, linear and paged
@pytest.mark.parametrize("split", fd.SPLITS)
@pytest.mark.parametrize("b,h,h_kv,s,d,dtype,tol", [
    (4, 8, 8, 1300, 64, torch.bfloat16, 2 ** -7),
    (4, 8, 8, 1300, 112, torch.bfloat16, 2 ** -7),
    (4, 12, 2, 1300, 128, torch.bfloat16, 2 ** -7),
    (4, 32, 8, 1300, 160, torch.bfloat16, 2 ** -7),
    (3, 8, 2, 1300, 128, torch.float32, 1e-5),
    (3, 32, 8, 1300, 160, torch.float32, 1e-5),
])
def test_decode_splits_match_plain(cuda, split, b, h, h_kv, s, d, dtype,
                                   tol):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    q, k, v, lengths, (kp, vp), pages = _decode_inputs(gen, b, h, h_kv, s,
                                                       d, dtype)
    out = fd.flash_decode(q, k, v, lengths, split=split)
    out_p = fd.flash_decode_paged(q, kp, vp, pages, lengths, split=split)
    g = h // h_kv
    want = ref.flash_decode_ref(q, k.repeat_interleave(g, 2),
                                v.repeat_interleave(g, 2), lengths)
    want_p = ref.flash_decode_paged_ref(q, kp, vp, pages, lengths)
    torch.cuda.synchronize()
    assert float(out[0].abs().max()) == 0.0     # length 0 gives 0
    rows = slice(1, None)
    assert _err(out[rows], want[rows]) <= tol
    assert _err(out_p[rows], want_p[rows]) <= tol
    fits = lengths <= s
    assert torch.equal(out[fits], out_p[fits])


def test_decode_split_default_and_range(cuda):
    """The wrappers' default is 256; a split past the kernel's staged
    table (512) or below 1 is refused before any launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    q, k, v, lengths, _, _ = _decode_inputs(gen, 2, 4, 2, 700, 64,
                                            torch.bfloat16)
    assert torch.equal(fd.flash_decode(q, k, v, lengths),
                       fd.flash_decode(q, k, v, lengths, split=256))
    fd.reset_launches()
    for bad in (0, fd.SPLIT_MAX + 1):
        with pytest.raises(ValueError, match="split"):
            fd.flash_decode(q, k, v, lengths, split=bad)
    assert fd.LAUNCHES["flash_decode"] == 0


def test_tuned_table_routes_the_decode_split(cuda):
    """``ops`` takes the installed table's split for this card, one split
    per (head_dim, dtype) whatever the capacity; an explicit split wins;
    no table gives 256."""
    from repro_torch.kernels import autotune, ops
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    q, k, v, lengths, (kp, vp), pages = _decode_inputs(gen, 3, 4, 2, 1300,
                                                       64, torch.bfloat16)
    key = autotune.shape_key("flash_decode", 4096, 64, torch.bfloat16)
    autotune.set_table(autotune.AutotuneTable({
        "version": autotune.AUTOTUNE_VERSION, "created": 0.0,
        "meta": {"backend": "cuda",
                 "device_name": torch.cuda.get_device_name(cuda)},
        "entries": {key: {"backend": "kernel", "split": 128}}}))
    try:
        tuned = ops.flash_decode(q, k, v, lengths)       # capacity 1300
        tuned_p = ops.flash_decode_paged(q, kp, vp, pages, lengths)
        pinned = ops.flash_decode(q, k, v, lengths, split=512)
    finally:
        autotune.set_table(None)
    plain = ops.flash_decode(q, k, v, lengths)
    assert torch.equal(tuned, fd.flash_decode(q, k, v, lengths, split=128))
    assert torch.equal(tuned_p, fd.flash_decode_paged(q, kp, vp, pages,
                                                      lengths, split=128))
    assert torch.equal(pinned, fd.flash_decode(q, k, v, lengths, split=512))
    assert torch.equal(plain, fd.flash_decode(q, k, v, lengths, split=256))


@pytest.mark.parametrize("d", [64, 128, 160])
def test_one_pass_dkdv_matches_plain(cuda, d):
    """The bf16 dK/dV is one kernel at every head_dim (at D = 160 it
    spills, and still beats a dV pass then a dK pass): one launch a
    call, within the bf16 limit of the plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    shape = (1, 4, 1000, d)
    q, k, v, do = (torch.randn(shape, generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    fa.reset_launches()
    got = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta)
    want = ref.attention_bwd_dkdv_ref(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_dkdv"] == 1
    for g, w in zip(got, want):
        assert _err(g, w) <= 2 ** -7


@pytest.mark.parametrize("h,h_kv,d,dtype", [
    (12, 2, 128, torch.bfloat16),
    (4, 4, 64, torch.bfloat16),
    (6, 1, 64, torch.float32),
    (32, 32, 112, torch.bfloat16),
    (4, 4, 112, torch.float32),
    (32, 8, 160, torch.bfloat16),
    (32, 8, 160, torch.float32),
])
def test_decode_row_does_not_depend_on_the_batch(cuda, h, h_kv, d, dtype):
    """A slot's row alone (B = 1, in a longer cache) and among 8 slots of
    other lengths, through the linear and the paged kernel (among 8:
    through a wider table): all four bitwise equal. The split-K kernels'
    splits and merge order depend on the slot's length alone."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    b, s, i = 8, 1000, 2
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=cuda)
    lengths[i] = 777                    # several splits, a ragged last one
    q, k, v, lengths, (kp, vp), pages = _decode_inputs(
        gen, b, h, h_kv, s, d, dtype, lengths=lengths)
    wide = torch.cat([pages, torch.full((b, 3), -1, dtype=torch.int32,
                                        device=cuda)], 1).contiguous()
    one = slice(i, i + 1)
    k1, v1 = (torch.cat([t[one], torch.randn((1, 64, h_kv, d), generator=gen,
                                             device=cuda).to(dtype)], 1)
              for t in (k, v))
    outs = [fd.flash_decode(q, k, v, lengths)[i],
            fd.flash_decode(q[one], k1, v1, lengths[one])[0],
            fd.flash_decode_paged(q, kp, vp, wide, lengths)[i],
            fd.flash_decode_paged(q[one], kp, vp, pages[one].contiguous(),
                                  lengths[one])[0]]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_decode_step_on_the_card_takes_the_kernels(cuda):
    """No switch: decode on CUDA tensors launches the decode kernels, one
    per layer and step, the paged one under a block table; paged ==
    dense tokens."""
    cfg = dataclasses.replace(get_config("qwen2-vl-2b").reduced(),
                              dtype="float32")
    params = init_params(cfg, 0, device=cuda)
    prompts = [torch.randint(0, cfg.vocab, (n,)).numpy() for n in (5, 9, 3)]
    outs = []
    for paged in (False, True):
        eng = DecodeEngine(cfg, params, n_slots=2, max_len=32, segment=4,
                           paged=paged, page_size=8)
        fd.reset_launches()
        rids = [eng.submit(p, 6) for p in prompts]
        out = eng.run()
        steps = eng.stats["segments"] * eng.segment * cfg.n_layers
        key = "flash_decode_paged" if paged else "flash_decode"
        assert fd.LAUNCHES[key] == steps > 0
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("s,window,index", [
    (64, 64, [0, 63, 64, 200]), (48, 64, [5, 47, 48, 300])])
def test_ring_decode_matches_the_ring_mask(cuda, s, window, index):
    """A sliding window's ring of S <= window rows through the linear
    decode kernel with lengths min(index + 1, S), against the reference's
    ring-masked decode (``ref.ring_decode_ref``)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    b, h, h_kv, d = len(index), 8, 2, 128
    q = torch.randn((b, 1, h, d), generator=gen, device=cuda)
    k, v = (torch.randn((b, s, h_kv, d), generator=gen, device=cuda)
            for _ in range(2))
    index = torch.tensor(index, device=cuda)
    out = fd.flash_decode(q, k, v, (index + 1).clamp_max(s))
    want = ref.ring_decode_ref(q, k.repeat_interleave(4, 2),
                               v.repeat_interleave(4, 2), index, window)
    torch.cuda.synchronize()
    assert _err(out, want) <= 1e-5


def test_windowed_engine_on_the_card_takes_the_decode_kernel():
    """A windowed config serves through the linear decode kernel, one
    launch a layer and step, and the dense engine's tokens are solo
    generation's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from repro_torch.launch import serve
    cfg = dataclasses.replace(get_config("glm4-9b").reduced(),
                              dtype="float32", sliding_window=8)
    params = init_params(cfg, 0, device="cuda")
    prompts = [torch.randint(0, cfg.vocab, (n,)).numpy()
               for n in (5, 19, 3)]
    eng = DecodeEngine(cfg, params, n_slots=2, max_len=16, segment=4)
    fd.reset_launches()
    rids = [eng.submit(p, 10) for p in prompts]
    out = eng.run()
    assert fd.LAUNCHES["flash_decode"] == (
        eng.stats["segments"] * eng.segment * cfg.n_layers)
    for r, p in zip(rids, prompts):
        assert out[r] == serve.generate(
            cfg, params, torch.as_tensor(p)[None, :], max_new_tokens=10,
            max_len=16)[0].tolist()


def _ssd_inputs(gen, b, s, h, p, n, dtype):
    dev = gen.device

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x, dt = r(b, s, h, p), torch.nn.functional.softplus(r(b, s, h) - 1)
    a = -torch.exp(r(h) * 0.5)
    bm, cm, dy = r(b, s, n), r(b, s, n), r(b, s, h, p)
    return ([t.to(dtype) for t in (x, dt)] + [a]
            + [t.to(dtype) for t in (bm, cm, dy)])


# chip_smoke.py's limits: 1e-4 for f32 outputs (the chunk-local cumsum
# enters every exponent, see SSD_TOL there), two bf16 steps for y and dx
# from bf16 inputs
@pytest.mark.parametrize("b,s,h,p,n,dtype", [
    (1, 256, 3, 64, 64, torch.float32),
    (2, 512, 4, 128, 16, torch.float32),
    (1, 192, 2, 64, 16, torch.bfloat16),
    (1, 128, 2, 128, 64, torch.bfloat16),
])
def test_ssd_kernels_match_plain(cuda, b, s, h, p, n, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    x, dt, a, bm, cm, dy = _ssd_inputs(gen, b, s, h, p, n, dtype)
    ssd.reset_launches()
    y, st = ssd.ssd_fwd(x, dt, a, bm, cm, return_states=True)
    y_only = ssd.ssd_fwd(x, dt, a, bm, cm)
    raw = ssd.ssd_bwd(x, dt, a, bm, cm, st, dy)
    y_r, st_r = ref.ssd_fwd_ref(x, dt, a, bm, cm, chunk=ssd.CHUNK,
                                return_states=True)
    raw_r = ref.ssd_bwd_ref(x, dt, a, bm, cm, st_r, dy, chunk=ssd.CHUNK)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == {"ssd_fwd": 2, "ssd_bwd": 1}
    assert torch.equal(y, y_only)
    for got, want in ((y, y_r), (st, st_r), *zip(raw, raw_r)):
        assert got.dtype == want.dtype
        tol = 2 ** -7 if got.dtype == torch.bfloat16 else 1e-4
        assert _err(got, want) <= tol


@pytest.mark.parametrize("b,s,h,p,n,dtype", [
    (1, 256, 3, 64, 64, torch.float32),
    (2, 512, 4, 128, 16, torch.float32),
    (1, 192, 2, 64, 16, torch.bfloat16),
    (1, 128, 2, 128, 64, torch.bfloat16),
])
def test_ssd_passes_match_plain(cuda, b, s, h, p, n, dtype):
    """Each of the four SSD kernels alone against its pass's plain version
    on the same inputs (a chunk pass gets the plain state pass's output);
    the passes launched alone count no wrapper launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    x, dt, a, bm, cm, dy = _ssd_inputs(gen, b, s, h, p, n, dtype)
    L = ssd.CHUNK
    st = ref.ssd_fwd_state_ref(x, dt, a, bm, chunk=L)
    ds = ref.ssd_bwd_state_ref(dt, a, cm, dy, chunk=L)
    ssd.reset_launches()
    pairs = [
        (ssd.fwd_state(x, dt, a, bm), st),
        (ssd.fwd_chunk(x, dt, a, bm, cm, st),
         ref.ssd_fwd_chunk_ref(x, dt, a, bm, cm, st, chunk=L)),
        (ssd.bwd_state(dt, a, cm, dy), ds),
        *zip(ssd.bwd_chunk(x, dt, a, bm, cm, st, ds, dy),
             ref.ssd_bwd_chunk_ref(x, dt, a, bm, cm, st, ds, dy, chunk=L)),
    ]
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == {"ssd_fwd": 0, "ssd_bwd": 0}
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        tol = 2 ** -7 if got.dtype == torch.bfloat16 else 1e-4
        assert _err(got, want) <= tol


@pytest.mark.parametrize("b,s,h,p,n,dtype", [
    (1, 256, 3, 64, 64, torch.float32),
    (2, 200, 4, 128, 16, torch.float32),
    (1, 192, 2, 64, 16, torch.bfloat16),
])
def test_ssd_state_in_and_out_match_plain(cuda, b, s, h, p, n, dtype):
    """The forward from an initial state and with the final state, against
    its plain version; with both pointers null it is the training forward,
    bitwise. ``ssd_prefill`` pads a ragged S with dt = 0 rows, which leave
    the final state as the last real row left it."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    x, dt, a, bm, cm, _ = _ssd_inputs(gen, b, s, h, p, n, dtype)
    init = torch.randn((b, h, p, n), generator=gen, device=cuda)
    ssd.reset_launches()
    y0 = ssd.ssd(x, dt, a, bm, cm)
    y, final = ssd.ssd_prefill(x, dt, a, bm, cm, init)
    y_z, final_z = ssd.ssd_prefill(x, dt, a, bm, cm, torch.zeros_like(init))
    torch.cuda.synchronize()
    assert ssd.LAUNCHES == {"ssd_fwd": 3, "ssd_bwd": 0}
    assert torch.equal(y_z, y0)
    pad = -s % ssd.CHUNK
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (x, dt)] + [a] + [
        torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (bm, cm)]
    for start, y_k, f_k in ((init, y, final), (None, y_z, final_z)):
        y_r, f_r = ref.ssd_fwd_ref(*padded, chunk=ssd.CHUNK,
                                   init_state=start, return_final=True)
        tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
        assert _err(y_k, y_r[:, :s]) <= tol
        assert f_k.dtype == torch.float32 and _err(f_k, f_r) <= 1e-4
    st, fin = ssd.fwd_state(*padded[:4], init_state=init, return_final=True)
    st_r, fin_r = ref.ssd_fwd_state_ref(*padded[:4], chunk=ssd.CHUNK,
                                        init_state=init, return_final=True)
    assert torch.equal(st[:, :, 0], init)
    assert _err(st, st_r) <= 1e-4 and _err(fin, fin_r) <= 1e-4


def test_ssd_unsupported_shapes_raise(cuda):
    x = torch.zeros((1, 64, 2, 32), device=cuda)
    dt = torch.zeros((1, 64, 2), device=cuda)
    bm = torch.zeros((1, 64, 16), device=cuda)
    with pytest.raises(ValueError, match="P in"):
        ssd.ssd_fwd(x, dt, torch.zeros(2, device=cuda), bm, bm)
    with pytest.raises(TypeError):
        ssd.ssd_fwd(x.half(), dt.half(), torch.zeros(2, device=cuda),
                    bm.half(), bm.half())


def test_hybrid_training_on_the_card_takes_the_ssd_kernels(cuda):
    """No switch: a reduced zamba2 (two units) on CUDA tensors launches
    the SSD kernels once per Mamba2 layer (twice in the forward under
    per-unit remat) and the flash kernels once per shared-block
    application."""
    from repro_torch.data import make_batch
    from repro_torch.train import (TrainConfig, accumulate_gradients,
                                   make_loss_and_grad)
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              dtype="float32", n_layers=18)
    params = init_params(cfg, 0, device=cuda)
    batch = make_batch(cfg, 2, 100, device=cuda)
    ssd.reset_launches()
    fa.reset_launches()
    loss, _ = accumulate_gradients(make_loss_and_grad(cfg, TrainConfig()),
                                   params, batch, 2)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    micro = 2
    assert ssd.LAUNCHES == {"ssd_fwd": 2 * 18 * micro,
                            "ssd_bwd": 18 * micro}
    assert fa.LAUNCHES == {"flash_fwd": 2 * 2 * micro,
                           "flash_bwd_dq": 2 * micro,
                           "flash_bwd_dkdv": 2 * micro}
