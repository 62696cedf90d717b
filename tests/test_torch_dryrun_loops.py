"""The dry-run's loops counted from their trips, and the records of the
architectures whose catalogue entries failed (``launch/dryrun.py``,
``util/loops.py``, ``models/moe.py``, ``models/ssm.py``,
``models/xlstm.py``).

The port's side runs in one subprocess with its own time limit (fake
process groups of 1 and 4 ranks). For each case the same record is
traced twice: with every loop trip run (``scale_loops=False``) and with
the trips that repeat an identical one counted from it; every count
must be equal, the peak of live bytes included. The cases scale each
loop that goes through ``util.loops.scan``: the plain SSD's chunks
forward and backward (zamba2-7b; a prefill whose S the chunk does not
divide), the mLSTM's chunks and the sLSTM's tokens under autograd and
activation checkpointing (xlstm-1.3b train) and without (prefill), and
the micro-batches of a dense train step (4 even ones, and 8 with a
ragged last one), each on a (1, 1) and a (2, 2) world.

Then the repaired records on a (2, 2) world read ``ok``: llama4-maverick
(the expert products on a dispatched block whose local layout DTensor's
strides misdescribe), zamba2-7b, xlstm-1.3b (train, prefill, decode, and
long-decode with its state sharded along d) and llama3-405b. Last, the
FLOPs of reduced configs against the reference's HLO FLOPs, each
difference derived from the config.
"""
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import get_config as ref_config
from test_torch_dryrun import ref_prefill_flops, ref_train_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = ("flops_per_device", "bytes_per_device",
          "collective_bytes_per_device", "n_allgather", "n_allreduce",
          "n_reducescatter", "n_alltoall", "n_collectivepermute",
          "memory_analysis")
# (case, mesh, arch, kind, seq, batch, accum, config overrides)
SCALED = (
    ("zamba2-train", (1, 1), "zamba2-7b", "train", 512, 2, 1, {}),
    ("zamba2-train", (2, 2), "zamba2-7b", "train", 512, 4, 1, {}),
    ("zamba2-prefill-padded", (1, 1), "zamba2-7b", "prefill", 1000, 2, 1,
     {}),
    ("zamba2-prefill-padded", (2, 2), "zamba2-7b", "prefill", 1000, 2, 1,
     {}),
    ("mlstm-train", (1, 1), "xlstm-1.3b", "train", 1280, 2, 1,
     {"n_layers": 2, "slstm_every": 0}),
    ("xlstm-train", (1, 1), "xlstm-1.3b", "train", 64, 2, 1,
     {"n_layers": 2, "slstm_every": 2}),
    ("xlstm-train", (2, 2), "xlstm-1.3b", "train", 64, 4, 1,
     {"n_layers": 2, "slstm_every": 2}),
    ("xlstm-prefill", (1, 1), "xlstm-1.3b", "prefill", 1024, 2, 1,
     {"n_layers": 2, "slstm_every": 2}),
    ("xlstm-prefill", (2, 2), "xlstm-1.3b", "prefill", 1024, 2, 1,
     {"n_layers": 2, "slstm_every": 2}),
    ("dense-accum4", (1, 1), "minicpm-2b", "train", 64, 8, 4, {}),
    ("dense-accum4", (2, 2), "minicpm-2b", "train", 64, 8, 4, {}),
    ("dense-ragged", (1, 1), "minicpm-2b", "train", 64, 15, 8, {}),
    ("dense-ragged", (2, 2), "minicpm-2b", "train", 64, 15, 8, {}),
)
# (arch, shape name, kind, seq, batch, accum): reduced records on (2, 2)
REPAIRED = (
    ("llama4-maverick-400b-a17b", "t", "prefill", 64, 4, 1),
    ("llama4-maverick-400b-a17b", "t", "train", 64, 8, 2),
    ("zamba2-7b", "t", "prefill", 128, 4, 1),
    ("zamba2-7b", "t", "train", 128, 4, 2),
    ("xlstm-1.3b", "t", "train", 64, 4, 1),
    ("xlstm-1.3b", "t", "prefill", 64, 4, 1),
    ("xlstm-1.3b", "t", "decode", 64, 4, 1),
    ("xlstm-1.3b", "long_500k", "decode", 64, 1, 1),
    ("llama3-405b", "t", "train", 64, 8, 4),
)
REF_FLOPS = (("xlstm-1.3b", "prefill"), ("xlstm-1.3b", "train"),
             ("zamba2-7b", "train"), ("llama4-maverick-400b-a17b", "prefill"))

PORT = r"""
import dataclasses, json, sys
sys.path[:0] = [{src!r}]
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.util import loops

SCALED, REPAIRED, REF_FLOPS = {scaled!r}, {repaired!r}, {ref_flops!r}
out = {{"scaled": {{}}, "repaired": {{}}, "flops": {{}}}}


def cfg_of(arch, over=None):
    return dataclasses.replace(get_config(arch).reduced(), **(over or {{}}))


def record(mesh, arch, name, kind, seq, batch, accum, over=None, **kw):
    try:
        r = D.trace(arch, name, mesh, mesh_label="x",
                    shape=InputShape(name, seq, batch, kind),
                    cfg=cfg_of(arch, over), accum_steps=accum, **kw)
        r.pop("_ops")
        return r
    except Exception as e:
        return {{"status": "error", "error": repr(e)[:1500]}}


# a toy loop: 10 trips of a matmul and a collective, the last ragged
def toy(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    res = {{}}
    with FakeTensorMode():
        a = distribute_tensor(torch.zeros(40, 64), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.zeros(64, 32), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)

        def body(t, _):
            rows = a[4 * t:4 * t + (4 if t < 9 else 2)]
            return None, (rows @ w).sum()

        for scale in (False, True):
            c = D.OpCounter(scale_loops=scale)
            c.track(a, w)
            with c:
                _, ys = loops.scan(body, None, 10)
            res[scale] = dict(D.totals(c.ops), peak=c.peak_bytes,
                              n_outs=len(ys), not_run=c.trips_not_run)
    return res


# the MoE repair's helper on a block whose layout its strides misdescribe
def contiguous(mesh):
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.sharding.hooks import contiguous_local
    with FakeTensorMode():
        x = distribute_tensor(torch.zeros(4, 6, 8), mesh,
                              [Shard(0), Shard(1)], src_data_rank=None)
        y = x.permute(1, 0, 2)
        c = D.OpCounter()
        c.track(y)
        with c:
            z = contiguous_local(y)
        return dict(D.totals(c.ops), before=y._local_tensor.is_contiguous(),
                    after=z._local_tensor.is_contiguous(),
                    strides=list(z.stride()), placements=str(z.placements))


for shape in ((1, 1), (2, 2)):
    with D.fake_world(shape[0] * shape[1]):
        mesh = D.fake_mesh(shape, ("data", "model"))
        out["toy %d" % shape[1]] = toy(mesh)
        if shape == (2, 2):
            out["contiguous"] = contiguous(mesh)
        for case, ms, arch, kind, seq, batch, accum, over in SCALED:
            if tuple(ms) != shape:
                continue
            out["scaled"]["%s %dx%d" % (case, *shape)] = [
                record(mesh, arch, "t", kind, seq, batch, accum, over,
                       scale_loops=scale) for scale in (False, True)]
        if shape == (2, 2):
            for arch, name, kind, seq, batch, accum in REPAIRED:
                out["repaired"]["%s %s %s" % (arch, name, kind)] = record(
                    mesh, arch, name, kind, seq, batch, accum)
        else:
            for arch, kind in REF_FLOPS:
                r = record(mesh, arch, "t", kind, 64,
                           2 if kind == "prefill" else 4, 2)
                out["flops"]["%s %s" % (arch, kind)] = r.get(
                    "flops_per_device", r)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, "-c",
         PORT.format(src=os.path.join(ROOT, "src"), scaled=SCALED,
                     repaired=REPAIRED, ref_flops=REF_FLOPS)],
        capture_output=True, text=True, env=env, timeout=900)
    assert run.returncode == 0, run.stderr[-6000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("key", [f"{c} {m[0]}x{m[1]}"
                                 for c, m, *_ in SCALED])
def test_scaled_counts_equal_every_trip_run(port, key):
    eager, scaled = port["scaled"][key]
    assert eager["status"] == scaled["status"] == "ok", (eager, scaled)
    for count in COUNTS:
        assert scaled[count] == eager[count], count
    assert eager["loop_trips_not_run"] == 0
    assert scaled["loop_trips_not_run"] > 0
    assert scaled["memory_analysis"]["temp_bytes"] > 0


@pytest.mark.parametrize("ranks", [1, 2])
def test_toy_loop_with_a_ragged_last_trip(port, ranks):
    """Ten trips, the last on half the rows: trips 2-8 are counted from
    trip 1 and the last runs; the collective's bytes, the FLOPs, bytes
    and peak equal those of the ten trips run."""
    eager, scaled = (port[f"toy {ranks}"][k] for k in ("false", "true"))
    assert eager["n_outs"] == scaled["n_outs"] == 10
    assert (eager["not_run"], scaled["not_run"]) == (0, 7)
    for key in ("flops_per_device", "bytes_per_device", "peak",
                "collective_bytes_per_device", "n_allgather"):
        assert scaled[key] == eager[key], key
    assert eager["flops_per_device"] > 0


def test_scan_without_an_observer_runs_every_trip():
    from repro_torch.util import loops
    carry, outs = loops.scan(lambda t, c: (c + t, t * t), 0, 6)
    assert (carry, outs) == (15, [0, 1, 4, 9, 16, 25])
    assert loops.scan(lambda t, c: (c, t), "x", 0) == ("x", [])


@pytest.mark.parametrize("key", [f"{a} {n} {k}"
                                 for a, n, k, *_ in REPAIRED])
def test_repaired_record_is_ok_on_2x2(port, key):
    r = port["repaired"][key]
    assert r["status"] == "ok", r
    assert r["n_devices"] == 4 and r["flops_per_device"] > 0
    assert r["collective_bytes_per_device"]["total"] > 0


def test_contiguous_local_moves_no_data(port):
    """The MoE repair makes a DTensor's local block contiguous and its
    global strides a contiguous tensor's, with no collective."""
    r = port["contiguous"]
    assert (r["before"], r["after"]) == (False, True)
    assert r["strides"] == [32, 8, 1]
    assert r["placements"] == "(Shard(dim=1), Shard(dim=0))"
    assert r["collective_bytes_per_device"] == {"total": 0.0}
    assert r["bytes_per_device"] > 0        # the local copy


def test_moe_experts_on_plain_tensors_unchanged():
    """``contiguous_local`` leaves a plain tensor as it is, so the
    unsharded expert products keep their bits."""
    import torch.nn.functional as F
    from repro_torch.models import moe
    from repro_torch.sharding.hooks import contiguous_local
    g = torch.Generator().manual_seed(0)
    xe = torch.randn(3, 4, 5, 16, generator=g).transpose(0, 1) \
        .contiguous().transpose(0, 1)
    w = {k: torch.randn(s, generator=g) for k, s in
         (("gate", (4, 16, 8)), ("up", (4, 16, 8)), ("down", (4, 8, 16)))}
    assert contiguous_local(xe) is xe
    h = F.silu(torch.einsum("tecd,edf->tecf", xe, w["gate"])) \
        * torch.einsum("tecd,edf->tecf", xe, w["up"])
    want = torch.einsum("tecf,efd->tecd", h, w["down"])
    assert torch.equal(moe._experts(w, xe), want)


def _ref_diff(arch, kind):
    """The port's FLOPs less the reference's HLO FLOPs, from the config
    (prefill B 2, train B 4 in 2 micro-batches of 2, S 64: one chunk of
    the mLSTM and of the SSD)."""
    cfg = ref_config(arch).reduced()
    s, accum = 64, 2
    b = 2
    if arch == "xlstm-1.3b":
        h = cfg.n_heads
        dh, dh_s = cfg.d_inner // h, cfg.d_model // h
        n_slstm = cfg.n_units
        n_mlstm = cfg.n_layers - n_slstm
        if kind == "prefill":
            # XLA drops the end-of-chunk state update (C and n) as dead
            # at one chunk; the port computes it
            return n_mlstm * (2 * b * h * dh * dh * s + 2 * b * h * dh * s)
        # a step: the port forms six (B, S, H)-by-Dh products a mLSTM
        # layer and micro-batch (q.n_t and the n update in the forward
        # and the recompute, q.n_t's two gradients), the reference's HLO
        # four; the reference's backward scan also takes the gradient of
        # the initial h through the first token's recurrent product,
        # which autograd skips (h0 needs no gradient)
        return accum * (n_mlstm * 2 * (2 * b * s * h * dh)
                        - n_slstm * 2 * b * h * dh_s * 4 * dh_s)
    if arch == "zamba2-7b":
        hs, n = cfg.n_ssm_heads, cfg.ssm_state
        p = cfg.d_inner // hs
        mamba, attn = cfg.n_units * cfg.pattern_unit(), cfg.n_units
        flash = 3 * 2 * b * cfg.n_heads * s * s * cfg.head_dim
        # the product sizes on which the two counts differ, a Mamba2
        # layer and micro-batch: four more (B, H, P, N) contractions over
        # the chunk's rows, two more per-head (B, S, S, H) by N products
        # (the dB, dC partials), one fewer C B^T (B, S, S) by N product,
        # two fewer head sums (the reference contracts the per-head dB,
        # dC partials; the port adds them)
        ssd = (4 * 2 * b * s * hs * p * n + 2 * 2 * b * s * s * hs * n
               - 2 * b * s * s * n - 2 * 2 * b * s * hs * n)
        return accum * (attn * flash + mamba * ssd)
    return 0


@pytest.mark.parametrize("arch,kind", REF_FLOPS)
def test_flops_against_the_reference(port, arch, kind):
    got = port["flops"][f"{arch} {kind}"]
    ref = ref_prefill_flops(arch) if kind == "prefill" \
        else ref_train_flops(arch)
    assert got - ref == _ref_diff(arch, kind)


def test_reference_differences_are_the_measured_ones():
    """The derived differences at the reduced configs, as measured."""
    assert [_ref_diff(a, k) for a, k in REF_FLOPS] == [
        118_358_016, 3_145_728, 208_601_088, 0]
    assert jax.devices()[0].platform == "cpu"
