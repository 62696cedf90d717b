"""Kernel autotuner for the card: per-shape-class choice among the
hand-written kernels' own variants, persisted as a versioned artifact (the
reference's ``kernels/autotune.py``).

The reference sweeps the Pallas kernels' tile sizes. The port's tiles are
fixed at compile time, so it tunes the knobs its CUDA kernels really
have at run time:

* ``flash_decode`` and ``flash_decode_paged``: ``split``, the key
  positions each split-K block takes (``csrc/flash_decode.cu``).
* ``flash_attention`` and ``ssd``: nothing (one form each; the SSD's
  chunk is 64, fixed by a Hopper block's shared memory); their classes
  record the kernel's, the plain version's and the library call's times.

A shape class is ``shape_key``: kind, sequence bucket (the exact page size
for paged decode), head dim and dtype, as in the reference. The sweep
times every candidate on the card, and beside them the plain PyTorch
version (``ref.py``, ``t_ref``) and, where one exists, one PyTorch
library call computing the same function (SDPA, ``t_lib``). Each timing
is N calls queued behind a sleeping kernel between two CUDA events, so a
call whose host work outlasts its kernels (decode) is timed by the
device, not by the host.

Two rules differ from the reference, on purpose:

* *No route to the plain version.* The reference routes a class to its
  XLA path (``backend: "ref"``) when that wins. On the card the plain
  version is a yardstick, and routing to it (or to a library call) would
  hide the hand-written kernel, so the winner is always a kernel
  candidate; ``t_ref`` and ``t_lib`` are recorded, never routed to, and
  :class:`AutotuneTable` refuses an entry with ``backend: "ref"``.
* *One decode split per (head_dim, dtype).* Another split sums a row's
  keys in another order, so the split must not depend on the cache's
  capacity or on paging: the engine (capacity ``max_len``) and
  ``generate``, a paged cache and a dense one, must give the same bits.
  The sweep picks, per (head_dim, dtype), the split with the least time
  summed over every linear and paged class of that pair, among the splits
  no slower than the default in any of them (so no class loses against
  the default), and writes it into each of those entries; the table
  refuses a payload whose decode entries disagree, and a decode class the
  sweep did not time takes its pair's split.

The table is honoured only where its timings were taken: on a CUDA
tensor, with ``meta.backend == "cuda"`` and the card's name equal to the
one it was tuned on. A table swept on the CPU (``device="cpu"``: every
candidate then times the plain version) is never used. A table is used
only once it is installed: :func:`set_table` installs one (``None``, the
state at import, routes every call to ``DEFAULTS``) and
:func:`reset_table` installs the one at ``path`` (default
``DEFAULT_PATH``). Nothing reads a table file on its own, and no
environment variable chooses one, so which routes run never depends on
which files happen to exist; the fleet's master sends its table with
each lease, so its agents route as it does. The port's artifact is
``artifacts/bench/autotune_cuda.json``; the reference's ``autotune.json``
is never read or written.

Artifact schema (version 2, the reference's)::

    {"version": 2, "created": ...,
     "meta": {"backend": "cuda"|"cpu", "device_name": ..., "card": ...,
              "smoke": bool, "iters": n, "timing": ...},
     "entries": {"<kind>|s<bucket>|d<dim>|<dtype>":
                 {"backend": "kernel", <knob>: value,
                  "t_best": s, "t_ref": s, "t_lib": s | null,
                  "t_default": s, "speedup_vs_default": x}}}
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.util.errors import ArtifactVersionError

from .flash_decode import SPLIT, SPLITS

AUTOTUNE_VERSION = 2
DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "..", "artifacts", "bench",
                            "autotune_cuda.json")

# today's behaviour, which the table replaces per class (and falls back to)
DEFAULTS = {
    "flash_attention": {},
    "flash_decode": {"split": SPLIT},
    "flash_decode_paged": {"split": SPLIT},
    "ssd": {},
}
DECODE_KINDS = ("flash_decode", "flash_decode_paged")


# ---------------------------------------------------------------------- #
# shape classes
# ---------------------------------------------------------------------- #
def seq_bucket(s: int) -> int:
    """Next power of two >= s, floored at 64 (one class per octave)."""
    b = 64
    while b < s:
        b *= 2
    return b


def dtype_name(dtype) -> str:
    """A torch dtype, a numpy dtype or a name -> its name ("bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype
    import numpy as np
    return np.dtype(dtype).name


def shape_key(kind: str, s: int, d: int, dtype) -> str:
    # paged decode keys on the exact page size: page sizes (8/16/32...)
    # sit below the 64-floor sequence bucket and would all collide
    b = int(s) if kind == "flash_decode_paged" else seq_bucket(int(s))
    return f"{kind}|s{b}|d{int(d)}|{dtype_name(dtype)}"


def _split_key(key: str) -> Tuple[str, int, str]:
    """(kind, head dim, dtype name) of a ``shape_key``."""
    kind, _, d, name = key.split("|")
    return kind, int(d[1:]), name


# ---------------------------------------------------------------------- #
# artifact I/O
# ---------------------------------------------------------------------- #
def save_artifact(payload: Dict, path: Optional[str] = None) -> str:
    if payload.get("version") != AUTOTUNE_VERSION:
        raise ValueError(f"refusing to save autotune artifact with version "
                         f"{payload.get('version')!r}")
    path = path or DEFAULT_PATH
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def load_artifact(path: Optional[str] = None) -> Dict:
    path = path or DEFAULT_PATH
    with open(path) as f:
        payload = json.load(f)
    version = payload.get("version")
    if version != AUTOTUNE_VERSION:
        raise ArtifactVersionError(path, version, AUTOTUNE_VERSION,
                                   kind="autotune artifact",
                                   detail="re-run python -m "
                                          "repro_torch.launch.autotune to "
                                          "regenerate")
    return payload


_CARD_NAMES: Dict[int, str] = {}


def _card_name(device: torch.device) -> str:
    """``torch.cuda.get_device_name`` of ``device``, read once a card."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    name = _CARD_NAMES.get(index)
    if name is None:
        name = _CARD_NAMES[index] = torch.cuda.get_device_name(index)
    return name


class AutotuneTable:
    """In-memory view of the artifact, consulted by :mod:`ops`."""

    def __init__(self, payload: Dict):
        version = payload.get("version")
        if version != AUTOTUNE_VERSION:
            raise ArtifactVersionError("<payload>", version,
                                       AUTOTUNE_VERSION,
                                       kind="autotune artifact")
        for field in ("entries", "meta"):
            if field not in payload:
                raise ArtifactVersionError(
                    "<payload>", version, AUTOTUNE_VERSION,
                    kind="autotune artifact",
                    detail=f"schema missing {field!r}")
        if "backend" not in payload["meta"]:
            raise ArtifactVersionError(
                "<payload>", version, AUTOTUNE_VERSION,
                kind="autotune artifact",
                detail="schema missing meta['backend']")
        self.payload = payload
        self.entries: Dict[str, Dict] = payload["entries"]
        self.backend: str = payload["meta"]["backend"]
        self.device_name: Optional[str] = payload["meta"].get("device_name")
        self._memo: Dict[tuple, Optional[Dict]] = {}
        # (head dim, dtype name) -> the split every decode class of it takes
        self.decode_splits: Dict[Tuple[int, str], int] = {}
        for key, entry in self.entries.items():
            if entry.get("backend") == "ref":
                raise ValueError(
                    f"autotune entry {key!r} routes to the plain version "
                    "(backend 'ref'): the port never routes a shape class "
                    "away from its hand-written kernel; the plain version "
                    "and the library call are timed as yardsticks only")
            kind, d, name = _split_key(key)
            if kind in DECODE_KINDS and "split" in entry:
                split = int(entry["split"])
                have = self.decode_splits.setdefault((d, name), split)
                if have != split:
                    raise ValueError(
                        f"autotune entries disagree on the decode split at "
                        f"head_dim {d}, {name}: {have} and {split} "
                        f"({key!r}); a row's bits depend on the split, so "
                        "every decode class of a (head_dim, dtype) must "
                        "take the same one")

    def lookup(self, kind: str, s: int, d: int, dtype,
               device) -> Optional[Dict]:
        """Tuned entry for this shape class, or None (the caller uses
        ``DEFAULTS``). Only on a CUDA ``device``, and only for a table
        tuned on the card of that name: the timings do not transfer. A
        decode class the sweep did not time takes its (head_dim, dtype)'s
        split. Answers are kept per argument tuple, so a decode step's
        calls after the first cost one dict lookup each."""
        memo = (kind, s, d, dtype, device)
        if memo in self._memo:
            return self._memo[memo]
        entry = None
        device = torch.device(device)
        if (self.backend == "cuda" and device.type == "cuda"
                and self.device_name == _card_name(device)):
            entry = self.entries.get(shape_key(kind, s, d, dtype))
            if entry is None and kind in DECODE_KINDS:
                split = self.decode_splits.get((int(d), dtype_name(dtype)))
                if split is not None:
                    entry = {"split": split}
        self._memo[memo] = entry
        return entry


# the installed table (None: every call takes DEFAULTS)
_TABLE: Optional[AutotuneTable] = None


def set_table(table: Optional[AutotuneTable]) -> None:
    """Install a table explicitly (None disables all tuned routing)."""
    global _TABLE
    _TABLE = table


def reset_table(path: Optional[str] = None) -> None:
    """Install the table at ``path`` (default ``DEFAULT_PATH``); an absent
    or stale artifact installs none: serving must never fail because a
    tuning artifact is missing."""
    try:
        table = AutotuneTable(load_artifact(path))
    except (FileNotFoundError, ValueError, KeyError):
        table = None
    set_table(table)


def get_table() -> Optional[AutotuneTable]:
    return _TABLE


def lookup(kind: str, s: int, d: int, dtype, device) -> Optional[Dict]:
    return None if _TABLE is None else _TABLE.lookup(kind, s, d, dtype,
                                                     device)


# ---------------------------------------------------------------------- #
# sweep machinery
# ---------------------------------------------------------------------- #
# candidates of the one knob (linear and paged decode share the split;
# attention and the SSD have one form each)
CANDIDATES = {"flash_decode": list(SPLITS)}

# The port's own classes, from the shapes its configs run (bf16 models;
# the SSD computes in f32). Attention (s, d, b, h): causal, seq 2048 at
# minicpm-2b's head_dim 64, zamba2-7b's shared block (112), qwen2-vl-2b
# (128) and stablelm-12b (160), and whisper-tiny's decoder seq 448.
ATTN_CLASSES = [(2048, 64, 1, 36), (2048, 112, 1, 32), (2048, 128, 1, 12),
                (2048, 160, 1, 32), (448, 64, 8, 6)]
# linear decode (capacity, d, b, h, h_kv): minicpm-2b's `generate`,
# zamba2-7b's, qwen2-vl-2b's engine, glm4-9b's ring of 8192 (its window),
# stablelm-12b's, whisper-tiny's self (448) and cross (1500) decode
DECODE_CLASSES = [(4096, 64, 8, 36, 36), (4096, 112, 8, 32, 32),
                  (4096, 128, 8, 12, 2), (8192, 128, 3, 32, 2),
                  (4096, 160, 8, 32, 8), (448, 64, 4, 6, 6),
                  (1500, 64, 4, 6, 6)]
# paged decode (page size, d, b, h, h_kv), 4096 positions a slot: the
# engines' page size (launch/engine.py)
PAGED_DECODE_CLASSES = [(16, 64, 8, 36, 36), (16, 112, 8, 32, 32),
                        (16, 128, 8, 12, 2), (16, 160, 8, 32, 8)]
PAGED_CAPACITY = 4096
# SSD (s, p, b, h, n): one zamba2-7b layer
SSD_CLASSES = [(2048, 64, 1, 112, 64)]
SMOKE_ATTN_CLASSES = [(128, 64, 1, 2), (128, 160, 1, 2)]
SMOKE_DECODE_CLASSES = [(300, 64, 2, 4, 2)]
SMOKE_PAGED_DECODE_CLASSES = [(16, 64, 2, 4, 2)]
SMOKE_PAGED_CAPACITY = 64
SMOKE_SSD_CLASSES = [(128, 64, 1, 2, 16)]
ATTN_DTYPE, DECODE_DTYPE, SSD_DTYPE = (torch.bfloat16, torch.bfloat16,
                                       torch.float32)
# clock rate that sizes the sleeping kernel (an H100 SXM boosts to 1.98
# GHz; a slower clock only sleeps longer)
_SLEEP_HZ = 2.0e9


def _time(fn: Callable[[], object], iters: int, device: torch.device,
          warmup: int = 1) -> float:
    """Seconds per call of ``fn``. On the card: ``iters`` calls queued
    behind a sleeping kernel, between two CUDA events, so the device runs
    them back to back however long the host takes to issue each one. On
    the CPU: the host's clock."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    issue = time.perf_counter() - t0      # the host's time for one call
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min((2 * issue * iters + 1e-3) * _SLEEP_HZ,
                              2e9)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _pick(rows: List[Dict], default_cfg: Dict, score_field: str,
          winner: Optional[Dict] = None) -> Dict:
    """Winner = argmin score over the kernel rows (``winner``, a config,
    fixes it instead); the plain version's row (``backend: "ref"``) and
    the library call's (``"library"``) are recorded, never chosen. The
    returned entry carries the winner's config and the times the
    acceptance check reads."""
    kern = [r for r in rows if r["backend"] == "kernel"]
    if winner is None:
        best = min(kern, key=lambda r: r[score_field])
    else:
        best = next(r for r in kern
                    if all(r[k] == v for k, v in winner.items()))
    t_ref = next(r[score_field] for r in rows if r["backend"] == "ref")
    t_lib = next((r[score_field] for r in rows
                  if r["backend"] == "library"), None)
    t_default = next(r[score_field] for r in kern
                     if all(r[k] == v for k, v in default_cfg.items()))
    entry = {k: v for k, v in best.items()
             if k != score_field and not k.startswith("t_")}
    entry["t_best"] = best[score_field]
    entry["t_ref"] = t_ref
    entry["t_lib"] = t_lib
    entry["t_default"] = t_default
    entry["speedup_vs_default"] = t_default / best[score_field]
    return entry


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _tune_flash_attention(classes, iters: int, device):
    import torch.nn.functional as F

    from . import flash_attention as _flash
    from . import ref as _ref

    entries, sweep = {}, {}
    for (s, d, b, h) in classes:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        q, k, v, do = (_randn(gen, (b, h, s, d), ATTN_DTYPE, device)
                       for _ in range(4))

        def kern():
            o, lse = _flash.flash_attention_fwd(q, k, v)
            delta = (do.float() * o.float()).sum(-1)
            _flash.flash_attention_bwd_dq(q, k, v, do, lse, delta)
            _flash.flash_attention_bwd_dkdv(q, k, v, do, lse, delta)

        def plain():
            o, lse = _ref.attention_ref(q, k, v)
            delta = (do.float() * o.float()).sum(-1)
            _ref.attention_bwd_dq_ref(q, k, v, do, lse, delta)
            _ref.attention_bwd_dkdv_ref(q, k, v, do, lse, delta)

        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def library():
            o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
            torch.autograd.grad(o, (ql, kl, vl), do)

        rows = [{"backend": "kernel",
                 "t_fwd_bwd": _time(kern, iters, device)},
                {"backend": "ref", "t_fwd_bwd": _time(plain, iters, device)},
                {"backend": "library",
                 "t_fwd_bwd": _time(library, iters, device)}]
        key = shape_key("flash_attention", s, d, ATTN_DTYPE)
        # timed on fwd + bwd, the training path's calls
        entries[key] = _pick(rows, DEFAULTS["flash_attention"], "t_fwd_bwd")
        sweep[key] = {"shape": {"b": b, "h": h, "s": s, "d": d,
                                "causal": True}, "rows": rows}
    return entries, sweep


def _decode_rows(fns, iters: int, device) -> List[Dict]:
    kern, plain, library = fns
    rows = [{"backend": "kernel", "split": sp,
             "t": _time(lambda sp=sp: kern(sp), iters, device)}
            for sp in CANDIDATES["flash_decode"]]
    rows.append({"backend": "ref", "t": _time(plain, iters, device)})
    rows.append({"backend": "library", "t": _time(library, iters, device)})
    return rows


def _tune_flash_decode(classes, iters: int, device):
    import torch.nn.functional as F

    from . import flash_decode as _decode
    from . import ref as _ref

    out = {}
    for (s, d, b, h, h_kv) in classes:
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        q = _randn(gen, (b, 1, h, d), DECODE_DTYPE, device)
        k, v = (_randn(gen, (b, s, h_kv, d), DECODE_DTYPE, device)
                for _ in range(2))
        lengths = torch.linspace(1, s, b, device=device).to(torch.int32)
        g = h // h_kv
        krep, vrep = (t.repeat_interleave(g, 2) for t in (k, v))
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (krep, vrep))
        valid = (torch.arange(s, device=device)[None, :]
                 < lengths[:, None])[:, None, None, :]
        rows = _decode_rows((
            lambda sp: _decode.flash_decode(q, k, v, lengths, split=sp),
            lambda: _ref.flash_decode_ref(q, krep, vrep, lengths),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=valid)),
            iters, device)
        key = shape_key("flash_decode", s, d, DECODE_DTYPE)
        out[key] = {"shape": {"b": b, "s": s, "h": h, "h_kv": h_kv, "d": d,
                              "lengths": lengths.tolist()}, "rows": rows}
    return out


def _tune_flash_decode_paged(classes, capacity: int, iters: int, device):
    import torch.nn.functional as F

    from . import flash_decode as _decode
    from . import ref as _ref

    out = {}
    for (ps, d, b, h, h_kv) in classes:
        gen = torch.Generator(device=device)
        gen.manual_seed(3)
        p_tab = capacity // ps
        n_pages = b * p_tab
        q = _randn(gen, (b, 1, h, d), DECODE_DTYPE, device)
        k_pool, v_pool = (_randn(gen, (n_pages, ps, h_kv, d), DECODE_DTYPE,
                                 device) for _ in range(2))
        pages = torch.arange(n_pages, dtype=torch.int32,
                             device=device).reshape(b, p_tab)
        lengths = torch.linspace(1, p_tab * ps, b,
                                 device=device).to(torch.int32)
        g = h // h_kv
        qt = q.transpose(1, 2).contiguous()
        kg, vg = (pool[pages.long()].reshape(b, p_tab * ps, h_kv, d)
                  .repeat_interleave(g, 2).transpose(1, 2).contiguous()
                  for pool in (k_pool, v_pool))
        valid = (torch.arange(p_tab * ps, device=device)[None, :]
                 < lengths[:, None])[:, None, None, :]
        rows = _decode_rows((
            lambda sp: _decode.flash_decode_paged(q, k_pool, v_pool, pages,
                                                  lengths, split=sp),
            lambda: _ref.flash_decode_paged_ref(q, k_pool, v_pool, pages,
                                                lengths),
            lambda: F.scaled_dot_product_attention(qt, kg, vg,
                                                   attn_mask=valid)),
            iters, device)
        key = shape_key("flash_decode_paged", ps, d, DECODE_DTYPE)
        out[key] = {"shape": {"b": b, "page_size": ps, "h": h, "h_kv": h_kv,
                              "d": d, "n_pages": n_pages,
                              "lengths": lengths.tolist()}, "rows": rows}
    return out


def choose_decode_splits(sweep: Dict[str, Dict]) -> Dict[Tuple[int, str],
                                                         int]:
    """One split per (head_dim, dtype) over every decode class of the
    pair: among the splits no slower than the default in any class, the
    one with the least summed time (the default on a tie)."""
    default = DEFAULTS["flash_decode"]["split"]
    times: Dict[Tuple[int, str], List[Dict[int, float]]] = {}
    for key, rec in sweep.items():
        kind, d, name = _split_key(key)
        if kind in DECODE_KINDS:
            times.setdefault((d, name), []).append(
                {r["split"]: r["t"] for r in rec["rows"]
                 if r["backend"] == "kernel"})
    chosen = {}
    for pair, per_class in times.items():
        ok = [sp for sp in per_class[0]
              if all(t[sp] <= t[default] for t in per_class)]
        chosen[pair] = min(ok, key=lambda sp: (sum(t[sp] for t in per_class),
                                               sp != default))
    return chosen


def _tune_ssd(classes, iters: int, device):
    from . import ref as _ref
    from . import ssd as _ssd

    entries, sweep = {}, {}
    for (s, p, b, h, n) in classes:
        gen = torch.Generator(device=device)
        gen.manual_seed(2)
        x = _randn(gen, (b, s, h, p), SSD_DTYPE, device)
        dt = torch.nn.functional.softplus(
            _randn(gen, (b, s, h), SSD_DTYPE, device) - 1.0)
        A = -torch.exp(_randn(gen, (h,), SSD_DTYPE, device) * 0.5)
        Bm, Cm = (_randn(gen, (b, s, n), SSD_DTYPE, device)
                  for _ in range(2))
        dy = _randn(gen, (b, s, h, p), SSD_DTYPE, device)

        def kern():
            _, states = _ssd.ssd_fwd(x, dt, A, Bm, Cm, return_states=True)
            _ssd.ssd_bwd(x, dt, A, Bm, Cm, states, dy)

        def plain():
            _, states = _ref.ssd_fwd_ref(x, dt, A, Bm, Cm, chunk=_ssd.CHUNK,
                                         return_states=True)
            _ref.ssd_bwd_ref(x, dt, A, Bm, Cm, states, dy, chunk=_ssd.CHUNK)

        rows = [{"backend": "kernel", "t_fwd_bwd": _time(kern, iters, device)},
                {"backend": "ref", "t_fwd_bwd": _time(plain, iters, device)}]
        key = shape_key("ssd", s, p, SSD_DTYPE)
        entries[key] = _pick(rows, DEFAULTS["ssd"], "t_fwd_bwd")
        sweep[key] = {"shape": {"b": b, "s": s, "h": h, "p": p, "n": n},
                      "rows": rows}
    return entries, sweep


def _nvidia_smi() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def run_autotune(smoke: bool = False, iters: Optional[int] = None,
                 device=None) -> Tuple[Dict, Dict]:
    """Sweep every kernel's candidates over its shape classes on
    ``device`` (the card unless ``"cpu"``).

    Returns (table_payload, bench_payload): the first is the versioned
    artifact :mod:`ops` consults; the second is the full sweep record for
    ``BENCH_autotune_cuda.json`` (every candidate's time, the plain
    version's and the library call's, the chosen knob and its speedup vs
    the default)."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    iters = iters if iters is not None else (2 if smoke else 10)
    attn = SMOKE_ATTN_CLASSES if smoke else ATTN_CLASSES
    dec = SMOKE_DECODE_CLASSES if smoke else DECODE_CLASSES
    paged = SMOKE_PAGED_DECODE_CLASSES if smoke else PAGED_DECODE_CLASSES
    capacity = SMOKE_PAGED_CAPACITY if smoke else PAGED_CAPACITY
    ssd_classes = SMOKE_SSD_CLASSES if smoke else SSD_CLASSES

    t0 = time.perf_counter()
    with torch.no_grad():
        dec_sweep = _tune_flash_decode(dec, iters, device)
        dec_sweep.update(_tune_flash_decode_paged(paged, capacity, iters,
                                                  device))
    splits = choose_decode_splits(dec_sweep)
    entries: Dict[str, Dict] = {}
    sweep: Dict[str, Dict] = {}
    for key, rec in dec_sweep.items():
        kind, d, name = _split_key(key)
        entries[key] = _pick(rec["rows"], DEFAULTS[kind], "t",
                             winner={"split": splits[(d, name)]})
    sweep.update(dec_sweep)
    e, s = _tune_flash_attention(attn, iters, device)
    entries.update(e)
    sweep.update(s)
    e, s = _tune_ssd(ssd_classes, iters, device)
    entries.update(e)
    sweep.update(s)
    on_card = device.type == "cuda"
    meta = {"backend": "cuda" if on_card else "cpu",
            "device_name": _card_name(device) if on_card else None,
            "card": _nvidia_smi() if on_card else None,
            "smoke": smoke, "iters": iters,
            "timing": ("cuda events around iters calls queued behind a "
                       "sleeping kernel" if on_card else "host clock"),
            "seconds": time.perf_counter() - t0}
    table_payload = {"version": AUTOTUNE_VERSION, "created": time.time(),
                     "meta": meta, "entries": entries}
    bench_payload = {"meta": meta, "defaults": DEFAULTS, "sweep": sweep,
                     "decode_splits": {f"d{d}|{name}": sp for (d, name), sp
                                       in sorted(splits.items())},
                     "entries": entries}
    return table_payload, bench_payload
