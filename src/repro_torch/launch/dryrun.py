"""Dry-run of the production plan (the reference's ``launch/dryrun.py``):
every (architecture x input shape x mesh), traced as one rank sees it on
the 16 x 16 (one pod, 256 devices) and 2 x 16 x 16 (two pods, 512) meshes.

    python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k \\
        [--multi-pod | --both-meshes] [--keep-trace] [--out PATH]

In place of XLA's placeholder devices, the run is rank 0 of a fake
process group (``torch.testing._internal.distributed.fake_pg``) of 256 or
512 ranks, started and destroyed here once per mesh, on fake CPU tensors
(``FakeTensorMode``): parameters, optimizer state, batch and cache are
DTensors at the plan's placements (``launch.specs``), and the step runs
eagerly on the rank's local blocks, the plain versions of the kernels
included. Nothing is allocated and no card is needed. Importing the
module does nothing; an installation without the fake group fails the
run with the import's message.

Each record keeps the reference's keys where the meaning carries over
(``arch``, ``shape``, ``mesh``, ``status``, ``reason``, ``n_devices``,
``accum_steps``, ``memory_analysis``, ``n_allgather`` ... and ``roofline``
with ``dominant``) and names the rest for what it counts, all per device
(one rank), every loop trip counted since the run is eager:

* ``flops_per_device``: ``torch.utils.flop_counter``'s formulas over the
  rank's local ops (matmuls, convolutions, attention; elementwise work
  counts 0, as in the reference's ``hlo_flops``);
* ``bytes_per_device``: each local op's operand and output bytes (views
  excluded). Eager execution runs unfused, so this is larger than the
  reference's fused count;
* ``collective_bytes_per_device``: each collective's output bytes by kind
  (the reference's ``hlo_stats`` convention), and ``total``. The fake
  mesh is a CPU mesh, where DTensor takes a shard-to-shard move as an
  all-gather and a chunk, not an all-to-all;
* ``memory_analysis``: ``argument_bytes``, the local blocks of every
  input; ``temp_bytes``, the peak of the step's live local storages less
  the arguments (``MemTracker`` would also count the global-shape
  stand-ins DTensor makes to propagate shapes: 1.6 TB on minicpm-2b's
  train_4k);
* ``seconds_trace``: host seconds the run took;
* ``roofline``: each term at an H100's rates (``launch/mesh.py``).

Records merge by (arch, shape, mesh) into
``artifacts/dryrun/dryrun_torch.json``. ``--keep-trace`` also writes each
record's counted ops (op, FLOPs, bytes, collective kind and bytes, with a
count of identical ones) as JSON lines beside it, from which
``launch.reanalyze`` recomputes the totals without tracing again. The
reference's HLO parsers (``hlo_stats.py``, ``hlo_flops.py``) have no
counterpart: the port has no HLO, and eager counting sees every trip.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from collections import Counter
from typing import Any, Dict, Optional

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun")
OUT_NAME = "dryrun_torch.json"
MOE_DISPATCH = "einsum"     # --moe-dispatch
TIME_LIMIT = 900.0          # --time-limit: host seconds a record may take
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# collective op name (``_c10d_functional`` or ``c10d``) -> kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-"
    "scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}


class TraceTimeout(RuntimeError):
    """A record ran past its time limit."""


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


# ---------------------------------------------------------------------- #
# the fake process group
# ---------------------------------------------------------------------- #
@contextlib.contextmanager
def fake_world(world_size: int):
    """Rank 0 of a fake process group of ``world_size`` ranks, destroyed
    on exit. Fails when the installation lacks the fake group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _strided_local_size(self, curr_local_size, num_chunks, rank,
                        offset_mode=None):
    """``_StridedShard.local_shard_size_and_offset`` without materializing
    indices: the dim is cut into ``split_factor`` pieces of ceil(n / f)
    and each into ``num_chunks`` of ceil(len / num_chunks) (``_split_tensor``
    and the method's own symbolic branch); rank ``rank`` holds its chunk
    of every piece. Offsets as ``offset_mode`` asks (first, all, none)."""
    from torch.distributed.tensor.placement_types import \
        _StridedShardOffsetMode
    mode = _StridedShardOffsetMode(
        offset_mode or _StridedShardOffsetMode.FIRST)
    n, f = int(curr_local_size), int(self.split_factor)
    first = -(-n // f)
    size, offsets = 0, []
    for j in range(f):
        lo, hi = min(first * j, n), min(first * (j + 1), n)
        second = -(-(hi - lo) // num_chunks)
        a = min(second * rank, hi - lo)
        b = min(second * (rank + 1), hi - lo)
        if b > a:
            size += b - a
            if mode is _StridedShardOffsetMode.ALL:
                offsets.extend(range(lo + a, lo + b))
            elif not offsets:
                offsets.append(lo + a)
    if mode is _StridedShardOffsetMode.NONE:
        return size, None
    if mode is _StridedShardOffsetMode.FIRST:
        return size, offsets[0] if offsets else -1
    return size, offsets


@contextlib.contextmanager
def _strided_shard_sizes_by_arithmetic():
    """DTensor sizes a strided shard (the flattening of a sharded dim
    with another, e.g. (B, S) -> B*S in a backward) by indexing a
    ``torch.arange`` of the dim; under ``FakeTensorMode`` that arange is
    fake and its ``tolist()`` fails as data-dependent, and on real
    tensors it costs a million-element list a call. For the trace's
    length the sizes come from ``_strided_local_size`` instead."""
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.local_shard_size_and_offset
    _StridedShard.local_shard_size_and_offset = _strided_local_size
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def fake_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


# ---------------------------------------------------------------------- #
# counting
# ---------------------------------------------------------------------- #
def _nbytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _is_view(func) -> bool:
    """An op that returns an alias of an input and writes nothing."""
    schema = func._schema
    writes = any(a.alias_info is not None and a.alias_info.is_write
                 for a in schema.arguments)
    return bool(schema.returns) and not writes and all(
        r.alias_info is not None for r in schema.returns)


class OpCounter:
    """The rank's local ops: FLOPs (``flop_counter``'s registry),
    operand + output bytes, collectives by kind.

    A DTensor-level op is not counted itself (the mode declines it and
    DTensor runs it); the local ops it runs are. DTensor also runs each
    op once on stand-ins of the global shapes to learn its output's
    metadata; those stand-ins descend from no input of the step, so only
    an op that reads a tensor of the step (``track``: the inputs' local
    blocks, then every counted op's outputs) is counted."""

    def __init__(self, deadline: Optional[float] = None):
        from torch.utils.weak import WeakIdKeyDictionary
        self.ops: Counter = Counter()   # (op, flops, bytes, kind, cbytes)
        self.deadline = deadline
        self._real: set = set()         # ids of the step's live tensors
        self._storages = WeakIdKeyDictionary()
        self.live_bytes = 0             # bytes of the step's live storages
        self.peak_bytes = 0
        self._mode = None

    def _mark(self, t) -> None:
        """Add ``t`` to the step's tensors while it lives (by id: a
        tensor's ``==`` is elementwise, so no weak set), and its storage
        to the live bytes until the storage is freed."""
        import weakref
        if id(t) in self._real:
            return
        self._real.add(id(t))
        weakref.finalize(t, self._real.discard, id(t))
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        weakref.finalize(st, self._free, n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def track(self, *trees) -> None:
        """Mark the tensors of ``trees`` (DTensors by their local blocks)
        as the step's own."""
        import torch
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        from repro_torch.train import OptState
        for tree in trees:
            if isinstance(tree, OptState):
                tree = (tree.m, tree.v)
            for t in tree_leaves(tree):
                if isinstance(t, DTensor):
                    t = t._local_tensor
                if isinstance(t, torch.Tensor):
                    self._mark(t)

    def __enter__(self):
        import torch
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry
        counter = self
        skip = {torch.ops.aten.is_contiguous.default,
                torch.ops.aten.is_contiguous.memory_format,
                torch.ops.aten.is_strides_like_format.default,
                torch.ops.aten.is_non_overlapping_and_dense.default,
                torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
                torch.ops.aten.stride.default,
                torch.ops.aten.sym_stride.default,
                torch.ops.aten.storage_offset.default,
                torch.ops.aten.sym_storage_offset.default,
                torch.ops.aten.numel.default,
                torch.ops.aten.sym_numel.default,
                torch.ops.aten.dim.default, torch.ops.prim.layout.default,
                torch.ops.prim.device.default}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func in skip:
                    return NotImplemented
                leaves = tree_leaves((args, kwargs))
                if any(isinstance(a, DTensor) for a in leaves):
                    return NotImplemented
                packet = func._overloadpacket
                out = func(*args, **kwargs)
                if any(isinstance(a, torch.Tensor)
                       and id(a) in counter._real for a in leaves):
                    for t in tree_leaves(out):
                        if isinstance(t, torch.Tensor):
                            counter._mark(t)
                    counter._record(func, packet, args, kwargs, out,
                                    flop_registry)
                return out

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)

    def _record(self, func, packet, args, kwargs, out, registry) -> None:
        if self.deadline is not None and time.perf_counter() > self.deadline:
            raise TraceTimeout("time limit reached")
        name = str(packet.__name__)
        kind = _COLLECTIVE_OPS.get(name) if func.namespace in (
            "_c10d_functional", "c10d") else None
        if kind is None and name == "wait_tensor":
            return
        flops = int(registry[packet](*args, **kwargs, out_val=out)) \
            if packet in registry else 0
        nbytes = 0 if _is_view(func) else (
            _nbytes(list(args)) + _nbytes(list(kwargs.values()))
            + _nbytes(out))
        cbytes = _nbytes(out) if kind else 0
        self.ops[(f"{func.namespace}.{name}", flops, nbytes, kind,
                  cbytes)] += 1


def totals(ops) -> Dict[str, Any]:
    """Per-device totals of counted ops: ``ops`` maps (op, flops, bytes,
    collective kind, collective bytes) to a count."""
    flops = nbytes = 0
    coll = {k: 0 for k in COLLECTIVE_KINDS}
    n_coll = {k: 0 for k in COLLECTIVE_KINDS}
    for (op, f, b, kind, cb), n in ops.items():
        flops += f * n
        nbytes += b * n
        if kind:
            coll[kind] += cb * n
            n_coll[kind] += n
    coll = {k: float(v) for k, v in coll.items() if n_coll[k]}
    coll["total"] = float(sum(coll.values()))
    return {"flops_per_device": float(flops),
            "bytes_per_device": float(nbytes),
            "collective_bytes_per_device": coll,
            "n_allgather": n_coll["all-gather"],
            "n_allreduce": n_coll["all-reduce"],
            "n_reducescatter": n_coll["reduce-scatter"],
            "n_alltoall": n_coll["all-to-all"],
            "n_collectivepermute": n_coll["collective-permute"]}


def roofline(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Each term at the H100's data-sheet rates (``launch/mesh.py``)."""
    from .mesh import CARD, HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
    out = {"compute_s": rec["flops_per_device"] / PEAK_FLOPS_BF16,
           "memory_s": rec["bytes_per_device"] / HBM_BW,
           "collective_s":
               rec["collective_bytes_per_device"]["total"] / NVLINK_BW}
    out["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                          key=lambda k: out[k])
    out["rates"] = {"peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW,
                    "nvlink_bw": NVLINK_BW, "card": CARD}
    return out


# ---------------------------------------------------------------------- #
# building the step
# ---------------------------------------------------------------------- #
def _arch_for(arch: str, shape):
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import variant_for_shape
    cfg = variant_for_shape(get_config(arch), shape)
    if cfg.moe_experts and cfg.moe_experts % 16 != 0:
        # pad experts to the 16-way EP axis (granite 40 -> 48)
        cfg = dataclasses.replace(
            cfg, moe_pad_to=((cfg.moe_experts + 15) // 16) * 16)
    if cfg.moe_experts and MOE_DISPATCH != "einsum":
        cfg = dataclasses.replace(cfg, moe_dispatch=MOE_DISPATCH)
    return cfg


def _fake_dtensors(mesh, tree, placements_tree):
    """DTensors at ``placements_tree`` of fake tensors shaped like the
    ``meta`` tensors of ``tree`` (call under ``FakeTensorMode``); a
    non-tensor leaf is kept."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.tree import flatten, unflatten
    pl = flatten(placements_tree)
    out = {}
    for path, t in flatten(tree).items():
        if not isinstance(t, torch.Tensor):
            out[path] = t
            continue
        full = torch.zeros(t.shape, dtype=t.dtype)
        out[path] = distribute_tensor(full, mesh, pl[path],
                                      src_data_rank=None)
    return unflatten(out)


def build(arch: str, shape_name: str, mesh, *,
          accum_steps: Optional[int] = None,
          seq_shard_override: Optional[bool] = None,
          optimized: bool = False, shape=None, cfg=None):
    """(cfg, rules, fn, args) for one combination; call under
    ``FakeTensorMode`` with a process group that spans ``mesh``.
    ``shape`` and ``cfg`` override the catalogue's ``InputShape`` and
    config (tests trace reduced configs at small shapes)."""
    import torch
    from repro_torch.configs.shapes import INPUT_SHAPES, input_specs
    from repro_torch.launch import specs as S
    from repro_torch.models import decode_step, forward
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train import OptState, TrainConfig, make_train_step
    shape = shape or INPUT_SHAPES[shape_name]
    cfg = cfg or _arch_for(arch, shape)
    seq_shard = (shape.name == "long_500k"
                 if seq_shard_override is None else seq_shard_override)
    rules = make_rules(mesh, seq_shard_cache=seq_shard)
    sds = input_specs(cfg, shape)
    p_shape = S.params_shape(cfg)
    params = _fake_dtensors(mesh, p_shape, S.param_shardings(rules, p_shape))

    if shape.kind == "train":
        accum = accum_steps or S.TRAIN_ACCUM_STEPS.get(arch, 1)
        o_shape = S.opt_shape(cfg, p_shape)
        o_pl = S.opt_shardings(rules, o_shape, p_shape)
        opt = OptState(step=0, m=_fake_dtensors(mesh, o_shape.m, o_pl.m),
                       v=_fake_dtensors(mesh, o_shape.v, o_pl.v))
        batch = _fake_dtensors(mesh, sds, S.batch_shardings(rules, sds))
        tc = TrainConfig(accum_steps=accum, reshard_grads=optimized,
                         grad_reduce_dtype="bfloat16" if optimized else None)
        step = make_train_step(cfg, tc)
        return cfg, rules, step, (params, opt, batch)
    if shape.kind == "prefill":
        batch = _fake_dtensors(mesh, sds, S.batch_shardings(rules, sds))

        def fn(params, batch):
            with torch.no_grad():
                return forward(cfg, params, batch, remat=False)[0]
        return cfg, rules, fn, (params, batch)
    cache = _fake_dtensors(mesh, sds["cache"], S.cache_shardings(
        rules, sds["cache"], seq_shard=seq_shard))
    tokens = _fake_dtensors(mesh, {"tokens": sds["tokens"]},
                            S.batch_shardings(rules, {"tokens":
                                                      sds["tokens"]}))

    def fn(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens["tokens"])
    return cfg, rules, fn, (params, cache, tokens)


def _argument_bytes(args) -> int:
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    from repro_torch.train import OptState
    total = 0
    for a in args:
        if isinstance(a, OptState):
            a = (a.m, a.v)
        for t in tree_leaves(a):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


def trace(arch: str, shape_name: str, mesh, *, mesh_label: str,
          accum_steps: Optional[int] = None, optimized: bool = False,
          time_limit: Optional[float] = None, shape=None, cfg=None
          ) -> Dict[str, Any]:
    """One record (see the module docstring), on ``mesh`` of the running
    (fake) process group. The ops counted are kept under the private
    key ``_ops`` for ``--keep-trace``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import INPUT_SHAPES, shape_applicable
    from repro_torch.launch import specs as S
    from repro_torch.sharding.hooks import activation_rules
    shape = shape or INPUT_SHAPES[shape_name]
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_label}
    skip = shape_applicable(cfg or get_config(arch), shape)
    if skip:
        return {**base, "status": "skipped", "reason": skip}
    t0 = time.perf_counter()
    deadline = None if time_limit is None else t0 + time_limit
    with FakeTensorMode(allow_non_fake_inputs=True), \
            _strided_shard_sizes_by_arithmetic():
        cfg, rules, fn, args = build(arch, shape_name, mesh,
                                     accum_steps=accum_steps,
                                     optimized=optimized, shape=shape,
                                     cfg=cfg)
        arg_bytes = _argument_bytes(args)
        counter = OpCounter(deadline)
        counter.track(*args)
        with activation_rules(rules.activation_table(), rules=rules):
            with counter:
                fn(*args)
    peak_total = counter.peak_bytes
    rec = {**base, "status": "ok", "n_devices": mesh.size(),
           "accum_steps": (accum_steps or S.TRAIN_ACCUM_STEPS.get(arch, 1)
                           if shape.kind == "train" else None),
           "seconds_trace": time.perf_counter() - t0,
           **totals(counter.ops),
           "memory_analysis": {
               "argument_bytes": arg_bytes,
               "temp_bytes": max(peak_total - arg_bytes, 0),
               "peak_tracked_bytes": peak_total}}
    rec["roofline"] = roofline(rec)
    rec["_ops"] = counter.ops
    return rec


def _trace_path(out: str, rec: Dict[str, Any]) -> str:
    base = os.path.splitext(out)[0]
    return f"{base}.{rec['arch']}_{rec['shape']}_{rec['mesh']}.ops.jsonl"


def write_ops(path: str, ops) -> None:
    with open(path, "w") as f:
        for (op, flops, nbytes, kind, cbytes), n in sorted(
                ops.items(), key=lambda kv: kv[0][0]):
            f.write(json.dumps({"op": op, "flops": flops, "bytes": nbytes,
                                "collective": kind,
                                "collective_bytes": cbytes,
                                "count": n}) + "\n")


def read_ops(path: str) -> Counter:
    ops: Counter = Counter()
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            ops[(r["op"], r["flops"], r["bytes"], r["collective"],
                 r["collective_bytes"])] += r["count"]
    return ops


def merge_records(out: str, records) -> None:
    """Merge ``records`` into the JSON list at ``out`` by (arch, shape,
    mesh)."""
    existing = []
    if os.path.exists(out):
        with open(out) as f:
            existing = json.load(f)
    key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
    merged = {key(r): r for r in existing}
    for r in records:
        merged[key(r)] = r
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(list(merged.values()), f, indent=1)


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.configs.shapes import INPUT_SHAPES
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_NAMES} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {tuple(INPUT_SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=None)
    ap.add_argument("--keep-trace", action="store_true",
                    help="write each record's counted ops as JSON lines")
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=("einsum", "scatter"))
    ap.add_argument("--optimized", action="store_true",
                    help="gradients reduce-scattered straight to the "
                         "parameters' placements, reduced in bf16")
    ap.add_argument("--time-limit", type=float, default=TIME_LIMIT,
                    help="host seconds a record may take (then status "
                         "'timeout')")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    global MOE_DISPATCH
    MOE_DISPATCH = args.moe_dispatch
    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out = args.out or os.path.join(ARTIFACT_DIR, OUT_NAME)

    records, failed = [], 0
    for mp in meshes:
        shape = (2, 16, 16) if mp else (16, 16)
        names = ("pod", "data", "model") if mp else ("data", "model")
        with fake_world(512 if mp else 256):
            mesh = fake_mesh(shape, names)
            for arch in archs:
                for shape_name in shapes:
                    tag = f"{arch} x {shape_name} x {mesh_name(mp)}"
                    try:
                        rec = trace(arch, shape_name, mesh,
                                    mesh_label=mesh_name(mp),
                                    accum_steps=args.accum_steps,
                                    optimized=args.optimized,
                                    time_limit=args.time_limit)
                    except TraceTimeout:
                        failed += 1
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name(mp), "status": "timeout",
                               "error": f"over {args.time_limit} s"}
                        print(f"[timeout] {tag}", flush=True)
                    except Exception as e:   # recorded, the run goes on
                        failed += 1
                        traceback.print_exc()
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name(mp), "status": "error",
                               "error": str(e)[:2000]}
                        print(f"[FAIL] {tag}: {e}", flush=True)
                    ops = rec.pop("_ops", None)
                    if rec["status"] == "ok":
                        if args.keep_trace:
                            rec["trace_path"] = _trace_path(out, rec)
                            os.makedirs(os.path.dirname(
                                os.path.abspath(out)), exist_ok=True)
                            write_ops(rec["trace_path"], ops)
                        coll = rec["collective_bytes_per_device"]["total"]
                        print(f"[ok] {tag}: {rec['seconds_trace']:.1f}s "
                              f"flops/dev={rec['flops_per_device']:.3e} "
                              f"coll/dev={coll:.3e}B dominant="
                              f"{rec['roofline']['dominant']}", flush=True)
                    elif rec["status"] == "skipped":
                        print(f"[skip] {tag}: {rec['reason']}", flush=True)
                    records.append(rec)
    merge_records(out, records)
    print(f"wrote {out} ({len(records)} new records, {failed} failures)")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
