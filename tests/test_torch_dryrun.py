"""The port's dry-run (``launch/dryrun.py``, ``launch/reanalyze.py``).

The port's numbers come from fake process groups, so they run in a
subprocess (one for the file, with a time limit of its own); the
reference's FLOPs from ``hlo_flops_bytes`` of the same function lowered
with ``jax.jit`` on the one CPU device, without activation rules (the
reference's own dry-run test fails under the installed jax). Reduced
configs, batch 2 and seq 64 for a prefill, batch 4, seq 64 and accum 2
for a train step.

* Prefill FLOPs equal the reference's exactly for minicpm-2b,
  qwen2-vl-2b and granite-moe-3b-a800m. zamba2-7b counts one
  (B, S, H, P, N) einsum a Mamba2 layer more: the chunk's state update,
  which XLA drops as dead at one chunk (the final state is unused).
* A train step counts 3 attention products a layer and micro-batch more
  than the reference: its plain attention keeps P and takes the four
  backward products, while the port's plain flash backward recomputes
  Q K^T in both its dQ and dK/dV passes and dO V^T in both (seven).
  granite-moe's also counts one routing-sized contraction less (see its
  test).
* On a (2, 2) fake mesh a prefill's per-device FLOPs are exactly a
  quarter of the (1, 1) count (every sharded dim divides), and a train
  step counts the plan's collectives: the FSDP all-gathers, the partial
  sums' all-reduces, and with ``optimized`` the gradients'
  reduce-scatters.
* A twin of the reference's ``test_collective_stats_trip_counts``: a
  DTensor matmul in a 10-trip loop counts 10 times one trip's bytes.
* ``reanalyze`` recomputes a record's totals from its kept op trace.
"""
import json
import os
import subprocess
import sys

import jax
import pytest

from repro.configs import get_config as ref_config
from repro.configs.shapes import InputShape as RefShape
from repro.configs.shapes import input_specs as ref_input_specs
from repro.launch import specs as RS
from repro.launch.hlo_flops import hlo_flops_bytes
from repro.models import forward as ref_forward
from repro.train import TrainConfig as RefTrainConfig
from repro.train import make_train_step as ref_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFILL_ARCHS = ("minicpm-2b", "qwen2-vl-2b", "granite-moe-3b-a800m")
TRAIN_ARCHS = ("minicpm-2b", "granite-moe-3b-a800m")

PORT = r"""
import json, sys, dataclasses
sys.path[:0] = [{src!r}]
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.sharding.hooks import activation_rules

PREFILL = InputShape("t", 64, 2, "prefill")
TRAIN = InputShape("t", 64, 4, "train")
out = {{"prefill": {{}}, "train": {{}}, "groups_left": []}}


def reduced(arch, dtype=None):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def rec(mesh, arch, shape, dtype=None, **kw):
    r = D.trace(arch, "t", mesh, mesh_label="x", shape=shape,
                cfg=reduced(arch, dtype), accum_steps=2, **kw)
    ops = r.pop("_ops")
    return r, ops


with D.fake_world(1):
    mesh = D.fake_mesh((1, 1), ("data", "model"))
    for arch in ("minicpm-2b", "qwen2-vl-2b", "granite-moe-3b-a800m",
                 "zamba2-7b"):
        out["prefill"][arch] = rec(mesh, arch, PREFILL)[0]["flops_per_device"]
    for arch in ("minicpm-2b", "granite-moe-3b-a800m"):
        out["train"][arch] = rec(mesh, arch, TRAIN)[0]["flops_per_device"]
    out["prefill_f32"] = rec(mesh, "minicpm-2b", PREFILL,
                             "float32")[0]["flops_per_device"]
    # FlopCounterMode over the same DTensor program: global == local here
    with FakeTensorMode(allow_non_fake_inputs=True):
        cfg, rules, fn, args = D.build("minicpm-2b", "t", mesh,
                                       shape=PREFILL, cfg=reduced("minicpm-2b"))
        fc = FlopCounterMode(display=False)
        with activation_rules(rules.activation_table(), rules=rules), fc:
            fn(*args)
    out["flop_counter_mode"] = fc.get_total_flops()
    # keep-trace round trip
    r, ops = rec(mesh, "minicpm-2b", PREFILL)
    path = {tmp!r} + "/ops.jsonl"
    D.write_ops(path, ops)
    r["trace_path"] = path
    with open({tmp!r} + "/records.json", "w") as f:
        json.dump([r], f)
    out["record"] = r
out["groups_left"].append(dist.is_initialized())

with D.fake_world(4):
    mesh = D.fake_mesh((2, 2), ("data", "model"))
    r, _ = rec(mesh, "minicpm-2b", PREFILL, "float32")
    out["prefill_2x2"] = r
    out["train_2x2"] = rec(mesh, "minicpm-2b", TRAIN)[0]
    out["train_2x2_optimized"] = rec(mesh, "minicpm-2b", TRAIN,
                                     optimized=True)[0]
    # collective bytes of a DTensor matmul, 1 trip and 10 trips
    trips = {{}}
    with FakeTensorMode():
        a = distribute_tensor(torch.zeros(128, 256), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.zeros(256, 512), mesh,
                              [Shard(1), Shard(0)], src_data_rank=None)
        for n in (1, 10):
            c = D.OpCounter()
            c.track(a, w)
            with c:
                for _ in range(n):
                    y = a @ w
            trips[n] = D.totals(c.ops)
    out["trips"] = trips
out["groups_left"].append(dist.is_initialized())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run(
        [sys.executable, "-c",
         PORT.format(src=os.path.join(ROOT, "src"), tmp=str(tmp))],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-6000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    out["tmp"] = str(tmp)
    return out


def ref_prefill_flops(arch):
    cfg = ref_config(arch).reduced()
    sds = ref_input_specs(cfg, RefShape("t", 64, 2, "prefill"))
    p = RS.params_shape(cfg)
    fn = jax.jit(lambda params, batch: ref_forward(cfg, params, batch,
                                                   remat=False)[0])
    return hlo_flops_bytes(fn.lower(p, sds).compile().as_text())["flops"]


def ref_train_flops(arch):
    cfg = ref_config(arch).reduced()
    sds = ref_input_specs(cfg, RefShape("t", 64, 4, "train"))
    p = RS.params_shape(cfg)
    o = RS.opt_shape(cfg, p)
    step = jax.jit(ref_train_step(cfg, RefTrainConfig(accum_steps=2)))
    return hlo_flops_bytes(step.lower(p, o, sds).compile().as_text())["flops"]


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_flops_equal_reference(port, arch):
    assert port["prefill"][arch] == ref_prefill_flops(arch)


def test_zamba2_prefill_counts_the_state_update(port):
    cfg = ref_config("zamba2-7b").reduced()
    b, s, h = 2, 64, cfg.n_ssm_heads
    p, n = cfg.d_inner // h, cfg.ssm_state
    layers = cfg.n_units * cfg.pattern_unit()
    state_update = 2 * b * s * h * p * n
    assert port["prefill"]["zamba2-7b"] - ref_prefill_flops("zamba2-7b") \
        == layers * state_update == 18_874_368


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_flops_differ_by_the_flash_recompute(port, arch):
    """granite-moe's step also counts 2 G g k E FLOPs a MoE layer and
    micro-batch less than the reference's: one contraction the size of
    the (group, token, choice, expert) routing one-hot, likely the gate
    values' gradient through the combine einsum, which XLA counts as a
    dot and PyTorch's einsum backward takes as a product and a sum
    (0 FLOPs)."""
    cfg = ref_config(arch).reduced()
    micro, s, accum = 2, 64, 2
    product = 2 * micro * cfg.n_heads * s * s * cfg.head_dim
    extra = 3 * product * cfg.n_layers * accum
    assert extra == 50_331_648
    if cfg.moe_experts:
        g = min(256, s)
        groups = micro * (s // g)
        e_pad = max(cfg.moe_experts, cfg.moe_pad_to)
        extra -= 2 * groups * g * cfg.moe_top_k * e_pad * cfg.n_layers \
            * accum
    assert port["train"][arch] - ref_train_flops(arch) == extra


def test_counter_equals_flop_counter_mode_on_one_rank(port):
    assert port["flop_counter_mode"] == port["prefill"]["minicpm-2b"]


def test_per_device_share_on_2x2(port):
    """In f32: in bf16 DTensor's cost model takes the SwiGLU gate and up
    products without the 'model' split (a rank does half of each, not a
    quarter), which the reference's constraints would not allow."""
    r = port["prefill_2x2"]
    assert r["n_devices"] == 4
    assert port["prefill_f32"] == port["prefill"]["minicpm-2b"]
    assert 4 * r["flops_per_device"] == port["prefill_f32"]
    # the FSDP all-gathers of the weights, the TP partial sums' reduction
    assert r["n_allgather"] > 0
    assert r["n_allreduce"] + r["n_reducescatter"] > 0
    mem = r["memory_analysis"]
    assert 0 < mem["argument_bytes"] < port["record"]["memory_analysis"][
        "argument_bytes"]


def test_train_collectives_on_2x2(port):
    plain, opt = port["train_2x2"], port["train_2x2_optimized"]
    for r in (plain, opt):
        assert r["status"] == "ok" and r["n_allgather"] > 0
        assert r["collective_bytes_per_device"]["total"] == sum(
            v for k, v in r["collective_bytes_per_device"].items()
            if k != "total")
    # reshard_grads reduce-scatters the gradients where the plain step
    # all-reduces them at full size, in bf16 at that
    assert opt["n_reducescatter"] > plain["n_reducescatter"]
    assert opt["collective_bytes_per_device"]["all-reduce"] < \
        plain["collective_bytes_per_device"]["all-reduce"]
    assert plain["roofline"]["dominant"] in ("compute_s", "memory_s",
                                             "collective_s")


def test_collective_bytes_count_every_trip(port):
    one, ten = port["trips"]["1"], port["trips"]["10"]
    assert one["collective_bytes_per_device"]["total"] > 0
    for key, v in one["collective_bytes_per_device"].items():
        assert ten["collective_bytes_per_device"][key] == 10 * v, key
    assert ten["flops_per_device"] == 10 * one["flops_per_device"]


def test_reanalyze_recomputes_totals(port):
    from repro_torch.launch import reanalyze
    path = os.path.join(port["tmp"], "records.json")
    before = json.load(open(path))[0]
    with open(path, "w") as f:
        broken = dict(before, flops_per_device=0.0, bytes_per_device=0.0,
                      roofline={})
        json.dump([broken], f)
    assert reanalyze.reanalyze(path) == 1
    after = json.load(open(path))[0]
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "n_allgather", "roofline"):
        assert after[key] == before[key], key


def test_no_group_left(port):
    import torch.distributed as dist
    assert port["groups_left"] == [False, False]
    assert not dist.is_initialized()


def test_skipped_combination_record():
    """whisper-tiny has no long_500k (the reference's skip reason)."""
    from repro_torch.launch import dryrun
    rec = dryrun.trace("whisper-tiny", "long_500k", None, mesh_label="16x16")
    assert rec["status"] == "skipped" and "448" in rec["reason"]


@pytest.mark.parametrize("split_factor", [1, 2, 3, 8])
def test_strided_shard_sizes_by_arithmetic(split_factor):
    """The dry-run's arithmetic for a strided shard's local size and
    offsets equals DTensor's own (which indexes a real arange)."""
    from torch.distributed.tensor.placement_types import (
        _StridedShard, _StridedShardOffsetMode)
    from repro_torch.launch.dryrun import _strided_local_size
    p = _StridedShard(0, split_factor=split_factor)
    for n in (0, 1, 7, 16, 45, 128, 130):
        for chunks in (1, 2, 3, 16):
            for rank in range(chunks):
                for mode in _StridedShardOffsetMode:
                    assert _strided_local_size(p, n, chunks, rank, mode) == \
                        p.local_shard_size_and_offset(n, chunks, rank, mode)
