"""Mamba2 SSD chunk scan on the card: wrappers around the CUDA kernels of
``csrc/ssd.cu`` and the ``torch.autograd.Function`` that joins them.

Each direction is two kernels, launched one after the other on the
caller's stream by one wrapper call: ``ssd_fwd`` runs the forward state
pass (each chunk's input state into ``states``, a scratch buffer when the
caller does not keep it) and then the forward chunk pass (y);
``ssd_bwd`` runs the backward state pass (each chunk's d(output state)
into a scratch buffer) and then the backward chunk pass. The forward
state pass also takes an initial state and gives the state leaving the
last chunk, which serving needs: ``ssd_prefill`` continues a cached state
over a prompt and returns the state a decode loop goes on from. ``fwd_state``,
``fwd_chunk``, ``bwd_state`` and ``bwd_chunk`` launch one pass each, for
the tests and the parity checks. ``LAUNCHES`` counts the calls of
``ssd_fwd`` and ``ssd_bwd`` that reached their kernels, and only those.

Model layout throughout: x (B,S,H,P), dt (B,S,H), A (H,) f32, Bm/Cm
(B,S,N). x, dt, Bm and Cm share one dtype, f32 or bf16; the arithmetic
is f32, y and dx come back in x's dtype. P is 64 or 128, N is 16 or 64,
and the kernels take S a multiple of ``CHUNK``: ``ssd`` pads S with
dt = 0, which makes the pad an exact no-op (dA = 0, so the carried state
passes through, and x dt = 0 adds nothing). Each wrapper routes on the
device of the tensor it is given: a CPU tensor takes the plain PyTorch
version (``ref.py``) at the same chunk; a CUDA tensor launches the kernels
or raises, never falls back.

Replaces the reference's ``kernels/mamba2_scan.py`` (``ssd_fwd``,
``ssd_bwd``, their ``custom_vjp`` and the padded entry ``ssd``). The
reference's chunk is 256; its backward's (256, 256) f32 tiles do not fit
a Hopper block's 227 KB of shared memory, so the chunk here is 64. The
chunk changes results only by f32 rounding.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.util.spans import span

from . import ref
from .flash_attention import _DTYPES

LAUNCHES: Dict[str, int] = {"ssd_fwd": 0, "ssd_bwd": 0}
CHUNK = 64
HEAD_DIMS = (64, 128)           # P
STATE_DIMS = (16, 64)           # N


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _route(t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no SSD path for device {t.device}")


def _check(name: str, x, dt, A, Bm, Cm, **extra) -> Tuple[int, ...]:
    """Validate the kernels' inputs; returns (B, S, H, P, N). x is the
    (B,S,H,P) operand (dy for the backward state pass)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        "(float32 or bfloat16)")
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"{name}: expected x (B,S,H,P) and Bm (B,S,N), "
                         f"got {tuple(x.shape)}, {tuple(Bm.shape)}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"{name}: P = {p}, N = {n}; the kernels take P in "
                         f"{HEAD_DIMS} and N in {STATE_DIMS}")
    if s % CHUNK:
        raise ValueError(f"{name}: S = {s} is not a multiple of the chunk "
                         f"{CHUNK}")
    states = ((b, h, s // CHUNK, p, n), torch.float32)
    want = {"dt": ((b, s, h), x.dtype), "A": ((h,), torch.float32),
            "Bm": ((b, s, n), x.dtype), "Cm": ((b, s, n), x.dtype),
            "states": states, "dstates": states,
            "init_state": ((b, h, p, n), torch.float32),
            "dy": (tuple(x.shape), x.dtype)}
    for key, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                   *extra.items()):
        if t is None:               # an optional input left out
            continue
        if key != "x" and (tuple(t.shape), t.dtype) != want[key]:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)} {t.dtype}, "
                             f"expected {want[key][0]} {want[key][1]}")
        if t.device != x.device:
            raise ValueError(f"{name}: {key} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        # the tiles come in by 16-byte copies
        if key not in ("dt", "A") and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    return b, s, h, p, n


def _launch(entry: str, *args) -> None:
    from .build import launch
    launch("ssd", entry, *args)


def _empty_states(x, b, s, h, p, n):
    return torch.empty((b, h, s // CHUNK, p, n), dtype=torch.float32,
                       device=x.device)


def _fwd_state(x, dt, A, Bm, dims, init_state=None, return_final=False):
    """Each chunk's input state, from ``init_state`` or 0 [, and the state
    leaving the last chunk]."""
    b, _, h, p, n = dims
    states = _empty_states(x, *dims)
    final = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
             if return_final else None)
    _launch("repro_ssd_fwd_state", x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            states.data_ptr(), None if final is None else final.data_ptr(),
            *dims, _DTYPES[x.dtype])
    return (states, final) if return_final else states


def _fwd_chunk(x, dt, A, Bm, Cm, states, dims):
    y = torch.empty_like(x)
    _launch("repro_ssd_fwd_chunk", x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), states.data_ptr(),
            y.data_ptr(), *dims, _DTYPES[x.dtype])
    return y


def _bwd_state(dt, A, Cm, dy, dims):
    dstates = _empty_states(dy, *dims)
    _launch("repro_ssd_bwd_state", dt.data_ptr(), A.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), dstates.data_ptr(), *dims,
            _DTYPES[dy.dtype])
    return dstates


def _bwd_chunk(x, dt, A, Bm, Cm, states, dstates, dy, dims):
    b, s, h, p, n = dims
    dx = torch.empty_like(x)
    ddt, dda = (torch.empty((b, s, h), dtype=torch.float32, device=x.device)
                for _ in range(2))
    dbh, dch = (torch.empty((b, s, h, n), dtype=torch.float32,
                            device=x.device) for _ in range(2))
    _launch("repro_ssd_bwd_chunk", x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), states.data_ptr(),
            dstates.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dda.data_ptr(), dbh.data_ptr(), dch.data_ptr(), *dims,
            _DTYPES[x.dtype])
    return dx, ddt, dda, dbh, dch


def fwd_state(x, dt, A, Bm, *, init_state=None, return_final=False):
    """The forward state pass alone: each chunk's input state
    (B,H,nc,P,N) f32 [, the state leaving the last chunk (B,H,P,N) f32],
    from ``init_state`` (B,H,P,N) f32 or 0."""
    if not _route(x):
        return ref.ssd_fwd_state_ref(x, dt, A, Bm, chunk=CHUNK,
                                     init_state=init_state,
                                     return_final=return_final)
    dims = _check("fwd_state", x, dt, A, Bm, Bm, init_state=init_state)
    return _fwd_state(x, dt, A, Bm, dims, init_state, return_final)


def fwd_chunk(x, dt, A, Bm, Cm, states):
    """The forward chunk pass alone: y (B,S,H,P) from each chunk's input
    state."""
    if not _route(x):
        return ref.ssd_fwd_chunk_ref(x, dt, A, Bm, Cm, states, chunk=CHUNK)
    dims = _check("fwd_chunk", x, dt, A, Bm, Cm, states=states)
    return _fwd_chunk(x, dt, A, Bm, Cm, states, dims)


def bwd_state(dt, A, Cm, dy):
    """The backward state pass alone: each chunk's d(output state)
    (B,H,nc,P,N) f32."""
    if not _route(dy):
        return ref.ssd_bwd_state_ref(dt, A, Cm, dy, chunk=CHUNK)
    return _bwd_state(dt, A, Cm, dy, _check("bwd_state", dy, dt, A, Cm, Cm))


def bwd_chunk(x, dt, A, Bm, Cm, states, dstates, dy):
    """The backward chunk pass alone: ``ssd_bwd``'s raw outputs from each
    chunk's input state and d(output state)."""
    if not _route(x):
        return ref.ssd_bwd_chunk_ref(x, dt, A, Bm, Cm, states, dstates, dy,
                                     chunk=CHUNK)
    dims = _check("bwd_chunk", x, dt, A, Bm, Cm, states=states,
                  dstates=dstates, dy=dy)
    return _bwd_chunk(x, dt, A, Bm, Cm, states, dstates, dy, dims)


def ssd_fwd(x, dt, A, Bm, Cm, *, return_states=False, init_state=None,
            return_final=False):
    """y (B,S,H,P) in x's dtype [, each chunk's input state (B,H,nc,P,N)
    f32, the backward's residual] [, the state leaving the last chunk
    (B,H,P,N) f32, a prefill's state for decode]. The scan starts from
    ``init_state`` (B,H,P,N) f32, or 0. S a multiple of ``CHUNK``. On the
    card: the forward state pass, then the chunk pass."""
    if not _route(x):
        return ref.ssd_fwd_ref(x, dt, A, Bm, Cm, chunk=CHUNK,
                               return_states=return_states,
                               init_state=init_state,
                               return_final=return_final)
    dims = _check("ssd_fwd", x, dt, A, Bm, Cm, init_state=init_state)
    states = _fwd_state(x, dt, A, Bm, dims, init_state, return_final)
    if return_final:
        states, final = states
    y = _fwd_chunk(x, dt, A, Bm, Cm, states, dims)
    LAUNCHES["ssd_fwd"] += 1
    extra = ([states] if return_states else []) \
        + ([final] if return_final else [])
    return (y, *extra) if extra else y


def ssd_bwd(x, dt, A, Bm, Cm, states, dy):
    """The raw backward: dx (B,S,H,P) in x's dtype; the direct part of
    ddt, d(dA) (B,S,H) and the per-head dB, dC partials (B,S,H,N), f32.
    On the card: the backward state pass into a (B,H,nc,P,N) f32 scratch
    buffer, then the chunk pass."""
    if not _route(x):
        return ref.ssd_bwd_ref(x, dt, A, Bm, Cm, states, dy, chunk=CHUNK)
    dims = _check("ssd_bwd", x, dt, A, Bm, Cm, states=states, dy=dy)
    dstates = _bwd_state(dt, A, Cm, dy, dims)
    raw = _bwd_chunk(x, dt, A, Bm, Cm, states, dstates, dy, dims)
    LAUNCHES["ssd_bwd"] += 1
    return raw


def combine_grads(x, dt, A, Bm, Cm, raw):
    """The chain rule outside the kernel, as the reference's ``ssd_bwd``:
    dA = A dt gives ddt += d(dA) A and dA_total = sum d(dA) dt; Bm and Cm
    are shared by the heads, so their partials are summed over heads."""
    dx, ddt, dda, dbh, dch = raw
    ddt = ddt + dda * A.to(dda.dtype)
    d_a = (dda * dt.to(dda.dtype)).sum(dim=(0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), d_a.to(A.dtype),
            dbh.sum(dim=2).to(Bm.dtype), dch.sum(dim=2).to(Cm.dtype))


class SSD(torch.autograd.Function):
    """The forward (keeping each chunk's input state) plus the backward.
    Under activation checkpointing the forward runs
    twice per layer and micro-batch: once in the forward pass and once
    in the recompute."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        y, states = ssd_fwd(x, dt, A, Bm, Cm, return_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        with span("repro_torch.kernels.ssd_bwd"):
            x, dt, A, Bm, Cm, states = ctx.saved_tensors
            raw = ssd_bwd(x, dt, A, Bm, Cm, states, dy.contiguous())
            return combine_grads(x, dt, A, Bm, Cm, raw)


def _padded(x, dt, A, Bm, Cm):
    """The operands with S padded to a multiple of ``CHUNK`` by rows of
    dt = 0 (zeros in x, Bm, Cm too), contiguous."""
    pad = -x.shape[1] % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    return [t.contiguous() for t in (x, dt, A, Bm, Cm)]


def ssd(x, dt, A, Bm, Cm) -> torch.Tensor:
    """Trainable Mamba2 SSD in model layout, any S: y (B,S,H,P)."""
    s = x.shape[1]
    args = _padded(x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y = SSD.apply(*args)
    else:
        y = ssd_fwd(*args)
    return y[:, :s]


def ssd_prefill(x, dt, A, Bm, Cm, init_state):
    """Forward-only Mamba2 SSD that continues a state, any S: (y
    (B,S,H,P), the state after the last row (B,H,P,N) f32), from
    ``init_state`` (B,H,P,N). A padded row has dt = 0: it decays the
    state by exp(A 0) = 1 and adds x dt B = 0, so the final state is the
    one after the last real row."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm, init_state)):
        raise ValueError("ssd_prefill is forward only")
    s = x.shape[1]
    y, final = ssd_fwd(*_padded(x, dt, A, Bm, Cm),
                       init_state=init_state.float().contiguous(),
                       return_final=True)
    return y[:, :s], final
