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
(one rank). A loop of the step that goes through ``util.loops.scan``
(micro-batches, the sLSTM's tokens, the mLSTM's and the plain SSD's
chunks) is traced until two trips in a row are identical, and the
trips that would repeat them are counted from the second, not run
(``OpCounter``; the reference's ``hlo_flops`` counts a ``while`` body once
times its trip count); every count equals that of a trace that runs
every trip:

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
* ``loop_trips_not_run``: the loop trips counted from an identical one;
* ``roofline``: each term at an H100's rates (``launch/mesh.py``).

Records merge by (arch, shape, mesh) into
``artifacts/dryrun/dryrun_torch.json``. ``--keep-trace`` also writes each
record's counted ops (op, FLOPs, bytes, collective kind and bytes, with a
count of identical ones) as JSON lines beside it, from which
``launch.reanalyze`` recomputes the totals without tracing again. The
reference's HLO parsers (``hlo_stats.py``, ``hlo_flops.py``) have no
counterpart: the port has no HLO.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
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


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    """An op that returns an alias of an input and writes nothing."""
    schema = func._schema
    writes = any(a.alias_info is not None and a.alias_info.is_write
                 for a in schema.arguments)
    return bool(schema.returns) and not writes and all(
        r.alias_info is not None for r in schema.returns)


def _counted(ops) -> Counter:
    """The ops that add to a total: a view of a tensor first counted in
    this trip (a loop's carry in its first trip) adds nothing."""
    return Counter({k: n for k, n in ops.items() if any(k[1:])})


class _Frame:
    """What one trip (or the whole step, at the bottom of the stack)
    counted: its ops, its peak of live bytes, the storages it made."""
    __slots__ = ("ops", "peak", "made", "serial")

    def __init__(self, live: int, serial: int):
        self.ops: Counter = Counter()
        self.peak = live
        self.made: list = []        # storage numbers (OpCounter._mark)
        self.serial = serial        # ranges registered before it began


class _Range:
    """The autograd nodes of a scaled loop's counted trip (``weight`` its
    copies + 1: an op its backward runs counts that many times) or of
    its last trip (``weight`` 1), sequence numbers [start, end); ``rep``
    the counted trip's start."""
    __slots__ = ("start", "end", "weight", "rep", "parent", "serial")

    def __init__(self, start, end, weight, rep, serial):
        self.start, self.end, self.weight, self.rep = start, end, weight, rep
        self.parent, self.serial = None, serial


class _Phantom:
    """The live bytes of the trips a scaled loop did not run: ``parts``,
    for each storage the counted trip kept, the bytes of its copies. A
    part is released when its storage is freed; if a backward frees it,
    the part waits (``deferred``) until the backward has left the
    counted trip (its nodes' lowest sequence number ``bound``), or left
    autograd, as the copies' own trips' backwards run before that."""
    __slots__ = ("parts", "deferred", "bound", "open", "frees")

    def __init__(self, parts):
        self.parts, self.deferred, self.bound = parts, 0, None
        self.open = False           # the loop's last trip is running
        self.frees = False          # the trip freed what came before it


class OpCounter:
    """The rank's local ops: FLOPs (``flop_counter``'s registry),
    operand + output bytes, collectives by kind.

    A DTensor-level op is not counted itself (the mode declines it and
    DTensor runs it); the local ops it runs are. DTensor also runs each
    op once on stand-ins of the global shapes to learn its output's
    metadata; those stand-ins descend from no input of the step, so only
    an op that reads a tensor of the step (``track``: the inputs' local
    blocks, then every counted op's outputs) is counted.

    Loops through ``util.loops.scan`` (``scale_loops``) are counted from
    their trips: trips run until two in a row count the same ops; the
    trips after the second of them are not run and count as many copies
    of it (each collective too), but for the last, which runs (a ragged
    one, or one whose backward differs) unless the loop is ``uniform``.
    The copies' live bytes join the step's: the peak over them is the
    counted trip's peak raised by the growth of the trips before it, and
    they are released with the storages the counted trip kept
    (``_Phantom``). A counted trip's backward, where autograd runs it
    after the loop, counts its ops as many more times: the op's autograd
    node (``torch._C._current_autograd_node``) falls in the trip's range
    of sequence numbers. The totals equal a trace that runs every trip
    (``tests/test_torch_dryrun_loops.py``)."""

    def __init__(self, deadline: Optional[float] = None,
                 scale_loops: bool = True):
        from torch.utils.weak import WeakIdKeyDictionary
        self.ops: Counter = Counter()   # (op, flops, bytes, kind, cbytes)
        self.deadline = deadline
        self.scale_loops = scale_loops
        self._real: set = set()         # ids of the step's live tensors
        self._storages = WeakIdKeyDictionary()
        self.live_bytes = 0             # bytes of the step's live storages
        self.peak_bytes = 0
        self._mode = None
        self._prev_observer = None
        self._frames = [_Frame(0, 0)]
        self._frames[0].ops = self.ops
        self._serial = 0                # the last storage's number
        self._sizes: Dict[int, int] = {}    # live storages' bytes
        self._ranges: list = []         # _Range, in registration order
        self._keys: list = []           # sorted (start, -end, index)
        self._waiting: Dict[int, list] = {}   # storage number -> phantoms
        self._bound: list = []          # phantoms waiting on a backward
        self._paused = False
        self.trips_not_run = 0          # loop trips counted, not run

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
        sid = self._serial = self._serial + 1   # ids are reused; this not
        self._storages[st] = sid
        self._sizes[sid] = n
        weakref.finalize(st, self._free, n, sid)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        frame = self._frames[-1]
        frame.made.append(sid)
        frame.peak = max(frame.peak, self.live_bytes)

    def _free(self, n: int, sid: int) -> None:
        self.live_bytes -= n
        self._sizes.pop(sid, None)
        phantoms = self._waiting.pop(sid, None)
        if not phantoms:
            return
        # freed by a scaled loop's backward (or by code that runs outside
        # any loop's nodes: a recompute, a Function's backward, a forward)
        rng = self._range_of_node()
        for ph in phantoms:
            part = ph.parts.pop(sid, None)
            if part is None or ph.open:
                # a carry the last trip replaced: its copies were freed
                # by the copies that followed them
                continue
            if rng is None:
                self.live_bytes -= part
                continue
            if ph.bound is None:
                ph.bound = rng.rep
            if not ph.deferred:
                self._bound.append(ph)
            ph.deferred += part

    # ------------------------------------------------------------------ #
    # loops
    # ------------------------------------------------------------------ #
    def _range_of_node(self) -> Optional[_Range]:
        """The innermost scaled trip whose autograd nodes hold the node
        autograd is running (None outside a backward)."""
        import bisect
        import torch
        if not self._ranges:
            return None
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        seq = node._sequence_nr()
        i = bisect.bisect_right(self._keys, (seq, float("inf"))) - 1
        rng = self._ranges[self._keys[i][2]] if i >= 0 else None
        while rng is not None and not rng.start <= seq < rng.end:
            rng = rng.parent
        return rng

    def _weight(self) -> int:
        """How many times an op counts: in the backward of a scaled trip
        registered since the innermost trip began, that trip's weight
        (and its enclosing scaled trips')."""
        if not self._ranges:
            return 1
        rng = self._range_of_node()
        serial, w = self._frames[-1].serial, 1
        while rng is not None:
            if rng.serial >= serial:
                w *= rng.weight
            rng = rng.parent
        return w

    def _release_bound(self) -> None:
        """Release the deferred parts of phantoms whose counted trip's
        backward has ended: autograd runs an older node, or none."""
        import torch
        node = torch._C._current_autograd_node()
        seq = -1 if node is None else node._sequence_nr()
        keep = []
        for ph in self._bound:
            if node is None or (ph.bound is not None and seq < ph.bound):
                self.live_bytes -= ph.deferred
                ph.deferred = 0
            else:
                keep.append(ph)
        self._bound = keep

    def _register(self, start: int, end: int, weight: int,
                  rep: int) -> None:
        import bisect
        if end <= start:
            return
        rng = _Range(start, end, weight, rep, len(self._ranges))
        lo = bisect.bisect_left(self._keys, (start, -end, -1))
        hi = bisect.bisect_left(self._keys, (end, float("-inf"), -1))
        for _, _, j in self._keys[lo:hi]:
            inner = self._ranges[j]
            if inner.parent is None and inner.end <= end:
                inner.parent = rng
        self._ranges.append(rng)
        bisect.insort(self._keys, (start, -end, rng.serial))

    def _storage_numbers(self, tree) -> list:
        """The numbers of the counted storages under ``tree``'s tensors
        (DTensors by their local blocks)."""
        import torch
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        out = []
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                sid = self._storages.get(t.untyped_storage())
                if sid is not None:
                    out.append(sid)
        return out

    def _placeholder(self, out):
        """A trip's outputs as detached aliases (uncounted): they stand
        for the outputs of the trips not run."""
        import torch
        from torch.utils._pytree import tree_map
        self._paused = True
        try:
            return tree_map(lambda x: x.detach() if isinstance(
                x, torch.Tensor) else x, out)
        finally:
            self._paused = False

    def scan(self, body, carry, n: int, uniform: bool = False):
        """``util.loops.scan`` counted from its trips (see the class); a
        ``uniform`` loop's last trip is counted as a copy too."""
        import torch
        seq = torch._C._autograd._get_sequence_nr
        outs, prev, t, ph, rep = [], None, 0, None, None
        while t < n:
            live0, seq0 = self.live_bytes, seq()
            frame = _Frame(live0, len(self._ranges))
            self._frames.append(frame)
            try:
                carry, out = body(t, carry)
            finally:
                self._frames.pop()
                parent = self._frames[-1]
                parent.ops.update(frame.ops)
                parent.peak = max(parent.peak, frame.peak)
                if len(self._frames) > 1:
                    parent.made.extend(frame.made)
            outs.append(out)
            # by its ops alone: a recompute under activation checkpointing
            # (which keeps what the first pass let go) must repeat the
            # first pass's trips
            sig = _counted(frame.ops)
            skip = n - (1 if uniform else 2) - t
            if rep is not None:             # the last trip, after copies
                self._register(seq0, seq(), 1, rep)
                break
            if skip > 0 and sig == prev:
                ph = self._repeat(frame, live0, skip, seq0, seq())
                if ph is not None:
                    ph.open = True
                outs.extend([self._placeholder(out)] * skip)
                if uniform:
                    if ph is not None and ph.frees:
                        # the trip freed its predecessor's carry, so each
                        # copy freed the one before it: the carry (but
                        # what the trip also handed out) stands for the
                        # last copy's alone
                        kept = set(self._storage_numbers(out))
                        for sid in self._storage_numbers(carry):
                            if sid not in kept:
                                ph.parts.pop(sid, None)
                    break
                t, rep = n - 1, seq0
            else:
                prev, t = sig, t + 1
        if ph is not None:
            ph.open = False
        return carry, outs

    def _repeat(self, frame, live0: int, m: int, seq0: int,
                seq1: int) -> Optional[_Phantom]:
        """Count ``m`` more copies of the trip just counted (``frame``,
        which began at ``live0`` live bytes and sequence number
        ``seq0``); returns the copies' live bytes, if they grow."""
        parent = self._frames[-1]
        self.trips_not_run += m
        for key, c in frame.ops.items():
            parent.ops[key] += c * m
        grow = self.live_bytes - live0
        peak = self.live_bytes + max((m - 1) * grow, 0) + frame.peak - live0
        self.peak_bytes = max(self.peak_bytes, peak)
        parent.peak = max(parent.peak, peak)
        self._register(seq0, seq1, m + 1, seq0)
        if grow <= 0:
            return None
        # the copies' growth; each storage the trip kept stands for m
        # copies, released with it (a carry that the last trip frees
        # stands for copies freed among the copies: ``open``)
        ph = _Phantom({sid: m * self._sizes[sid] for sid in frame.made
                       if sid in self._sizes})
        ph.frees = sum(ph.parts.values()) > m * grow
        self.live_bytes += m * grow
        for sid in ph.parts:
            self._waiting.setdefault(sid, []).append(ph)
        return ph

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
        from repro_torch.util import loops
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
                if not counter._paused and any(
                        isinstance(a, torch.Tensor) and id(a) in
                        counter._real for a in leaves):
                    if counter._bound:
                        counter._release_bound()
                    for t in tree_leaves(out):
                        if isinstance(t, torch.Tensor):
                            counter._mark(t)
                    counter._record(func, packet, args, kwargs, out,
                                    flop_registry)
                return out

        self._mode = Mode()
        self._mode.__enter__()
        if self.scale_loops:
            self._prev_observer = loops.set_observer(self)
        return self

    def __exit__(self, *exc):
        from repro_torch.util import loops
        if self.scale_loops:
            loops.set_observer(self._prev_observer)
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
        self._frames[-1].ops[(f"{func.namespace}.{name}", flops, nbytes,
                              kind, cbytes)] += self._weight()


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
          time_limit: Optional[float] = None, shape=None, cfg=None,
          scale_loops: bool = True) -> Dict[str, Any]:
    """One record (see the module docstring), on ``mesh`` of the running
    (fake) process group. The ops counted are kept under the private
    key ``_ops`` for ``--keep-trace``. ``scale_loops=False`` runs every
    loop trip (the tests' reference for the scaled counts)."""
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
        counter = OpCounter(deadline, scale_loops=scale_loops)
        counter.track(*args)
        with activation_rules(rules.activation_table(), rules=rules):
            with counter:
                fn(*args)
    peak_total = counter.peak_bytes
    rec = {**base, "status": "ok", "n_devices": mesh.size(),
           "accum_steps": (accum_steps or S.TRAIN_ACCUM_STEPS.get(arch, 1)
                           if shape.kind == "train" else None),
           "seconds_trace": time.perf_counter() - t0,
           "loop_trips_not_run": counter.trips_not_run,
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
