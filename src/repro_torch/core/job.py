"""Job and cluster state for the scheduling model (Section IV); the
port's copy of the reference's ``core/job.py``, with the hooks that keep
the vectorized decision paths' flat tables current."""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .perf_model import PerfParams, t_iter_at_workers

import numpy as _np


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUSPENDED = "suspended"   # only preemptive baselines use this
    FINISHED = "finished"


@dataclass
class Job:
    """One DDL training job J_k (Table I notation in comments)."""

    jid: int
    model: str                  # DL task name (indexes the xi table)
    arrival: float              # a_k
    gpus: int                   # G_k
    iters: float                # I_k
    batch: int                  # B_k - user-requested per-GPU batch size
    perf: PerfParams            # Eq. 3/4/7 coefficients at G_k workers

    # --- mutable scheduling state -------------------------------------
    state: JobState = JobState.PENDING
    placement: FrozenSet[int] = frozenset()     # GPU ids
    sub_batch: int = 0          # chosen per-GPU sub-batch (Algorithm 2)
    accum_steps: int = 1        # s = batch / sub_batch
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    first_start_time: Optional[float] = None
    iters_done: float = 0.0
    last_progress_at: float = 0.0
    current_rate: float = 0.0   # iterations / second right now
    preemptions: int = 0
    failures: int = 0           # injected faults that killed an attempt
    lost_iters: float = 0.0     # work rolled back to the last checkpoint
    attained_service: float = 0.0   # gpus * seconds (Tiresias)
    alloc_gpus: Optional[int] = None  # elastic allocation (Pollux-like only)
    waiting_time: float = 0.0       # total time not holding GPUs (queue + preempted)
    # memos: solo_t_iter keyed by sub_batch, t_iter keyed by the candidate
    # sub-batch / accumulation count (scheduler sort keys and Algorithm-2
    # sub-batch sweeps hit these millions of times on large traces), the
    # solo-fit sub-batch per capacity, and the Algorithm-2 candidate
    # arrays built lazily by :mod:`core.pair_batch`
    _t_iter_memo: Optional[tuple] = field(
        default=None, repr=False, compare=False)
    _t_iter_by_b: Dict[int, float] = field(
        default_factory=dict, repr=False, compare=False)
    _ert_memo: Optional[tuple] = field(
        default=None, repr=False, compare=False)
    _solo_sub_memo: Dict[float, Optional[int]] = field(
        default_factory=dict, repr=False, compare=False)
    _pair_table: Optional[tuple] = field(
        default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.sub_batch == 0:
            self.sub_batch = self.batch

    # ------------------------------------------------------------------ #
    @property
    def solo_t_iter(self) -> float:
        memo = self._t_iter_memo
        if memo is not None and memo[0] == self.sub_batch:
            return memo[1]
        val = self.perf.t_iter_sub(self.batch, self.sub_batch)
        self._t_iter_memo = (self.sub_batch, val)
        return val

    def base_t_iter(self) -> float:
        """Iteration time in *user iterations* given the current elastic
        allocation (equals ``solo_t_iter`` unless a Pollux-like scheduler
        resized the job). Weak scaling: per-GPU batch fixed, progress
        normalized so that n workers advance n/G_k user iterations per
        physical iteration (same total samples => same convergence)."""
        n = self.alloc_gpus or self.gpus
        if n == self.gpus:
            return self.solo_t_iter
        t_phys = t_iter_at_workers(self.perf, self.batch, self.accum_steps, n)
        return t_phys * self.gpus / n

    def t_iter_sub(self, sub_batch: int) -> float:
        """Memoized ``perf.t_iter_sub(batch, sub_batch)``: the
        Algorithm-2 sweep re-evaluates the same handful of candidate
        sub-batches for a job on every scheduling pass."""
        val = self._t_iter_by_b.get(sub_batch)
        if val is None:
            val = self.perf.t_iter_sub(self.batch, sub_batch)
            self._t_iter_by_b[sub_batch] = val
        return val

    @property
    def remaining_iters(self) -> float:
        return max(0.0, self.iters - self.iters_done)

    @property
    def expected_remaining_time(self) -> float:
        """L_k = t_iter * remaining iterations (solo estimate, used by
        SJF). Memoized on (iters_done, sub_batch): sort keys of queued
        jobs are re-read every scheduling pass but only change when the
        job actually progresses."""
        memo = self._ert_memo
        if (memo is not None and memo[0] == self.iters_done
                and memo[1] == self.sub_batch):
            return memo[2]
        val = self.solo_t_iter * self.remaining_iters
        self._ert_memo = (self.iters_done, self.sub_batch, val)
        return val

    @property
    def service_size(self) -> float:
        """Job 'size' used for the large/small split in Tables III-IV."""
        return self.gpus

    def jct(self) -> float:
        if self.finish_time is None:
            raise RuntimeError(f"job {self.jid} not finished")
        return self.finish_time - self.arrival

    def queueing_delay(self) -> float:
        """Total time spent without GPUs (initial queueing + time spent
        re-queued after preemption) — the paper's 'queuing delay', which
        charges preemptive policies for their migrations."""
        return self.waiting_time

    def first_start_delay(self) -> float:
        if self.first_start_time is None:
            raise RuntimeError(f"job {self.jid} never started")
        return self.first_start_time - self.arrival


@dataclass
class ClusterState:
    """Servers x GPUs with <= C jobs per GPU (C=2 in the paper).

    The free set, single-occupancy set, per-server free sets, and the
    donor (job -> #single-occupancy GPUs) index are maintained as O(Δ)
    updates inside :meth:`allocate`/:meth:`release` — the sharing
    schedulers read them every pass, and the previous version-gated
    full rescans were O(n_gpus) per pass at datacenter scale. The
    sorted list views handed to schedulers are materialized lazily from
    the sets (cached per occupancy version) so callers keep the exact
    id-ordering semantics of the original scan.
    """

    n_servers: int
    gpus_per_server: int
    max_jobs_per_gpu: int = 2
    gpu_capacity_bytes: float = 16 * 2**30

    occupancy: Dict[int, List[int]] = field(default_factory=dict)  # gpu -> [jid]
    # occupancy-version caches for the sorted list views; bumped on
    # every allocate/release
    _version: int = field(default=0, repr=False, compare=False)
    _free_cache: tuple = field(default=(-1, None), repr=False, compare=False)
    _single_cache: tuple = field(default=(-1, None), repr=False, compare=False)
    # incremental indexes (maintained by allocate/release)
    _free: Set[int] = field(default_factory=set, repr=False, compare=False)
    _single: Set[int] = field(default_factory=set, repr=False, compare=False)
    _free_by_server: List[Set[int]] = field(
        default_factory=list, repr=False, compare=False)
    _single_owner: Dict[int, int] = field(
        default_factory=dict, repr=False, compare=False)   # gpu -> sole jid
    _donor_count: Dict[int, int] = field(
        default_factory=dict, repr=False, compare=False)   # jid -> #single GPUs
    # per-server free-GPU counts as a flat preallocated array:
    # consolidated_pick_free reads it instead of
    # re-deriving bucket sizes, and the vectorized scheduling pass
    # (core.pass_batch) reads the attached FlatJobs mirror below
    _free_count: object = field(default=None, repr=False, compare=False)
    # optional core.pass_batch.FlatJobs attachment: when present,
    # donor-membership transitions are pushed into its flat donor index
    _flat: object = field(default=None, repr=False, compare=False)
    # servers currently failed: their GPUs are out of the free pool until
    # the matching recover event
    _down_servers: Set[int] = field(
        default_factory=set, repr=False, compare=False)

    def __post_init__(self) -> None:
        for g in range(self.n_gpus):
            self.occupancy.setdefault(g, [])
        self._free_by_server = [set() for _ in range(self.n_servers)]
        self._free_count = _np.zeros(self.n_servers, dtype=_np.int64)
        for g in range(self.n_gpus):
            occ = self.occupancy[g]
            if not occ:
                self._free.add(g)
                sid = self.server_of(g)
                self._free_by_server[sid].add(g)
                self._free_count[sid] += 1
            elif len(occ) == 1:
                self._mark_single(g, occ[0])

    @property
    def n_gpus(self) -> int:
        return self.n_servers * self.gpus_per_server

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_single(self) -> int:
        return len(self._single)

    @property
    def version(self) -> int:
        """Occupancy version, bumped on every allocate/release — lets
        callers cache occupancy-derived views (donor batches, sorted
        GPU lists) and invalidate them on placement changes."""
        return self._version

    def server_of(self, gpu: int) -> int:
        return gpu // self.gpus_per_server

    # -- incremental index maintenance --------------------------------- #
    def _mark_single(self, gpu: int, jid: int) -> None:
        self._single.add(gpu)
        self._single_owner[gpu] = jid
        self._donor_count[jid] = count = self._donor_count.get(jid, 0) + 1
        if self._flat is not None:
            self._flat.set_donor_singles(jid, count)

    def _unmark_single(self, gpu: int) -> None:
        self._single.discard(gpu)
        jid = self._single_owner.pop(gpu)
        left = self._donor_count[jid] - 1
        if left:
            self._donor_count[jid] = left
        else:
            del self._donor_count[jid]
        if self._flat is not None:
            self._flat.set_donor_singles(jid, left)

    # ------------------------------------------------------------------ #
    def free_gpus(self) -> List[int]:
        """GPUs with no tenant, in id order. Callers must treat the
        result as read-only: it is cached until the next
        allocate/release."""
        if self._free_cache[0] != self._version:
            self._free_cache = (self._version, sorted(self._free))
        return self._free_cache[1]

    def single_occupancy_gpus(self) -> List[int]:
        """GPUs with exactly one tenant (sharing candidates), in id
        order. Read-only; cached until the next allocate/release."""
        if self._single_cache[0] != self._version:
            self._single_cache = (self._version, sorted(self._single))
        return self._single_cache[1]

    def donor_jids(self) -> Set[int]:
        """Jobs owning at least one single-occupancy GPU (the Algorithm-1
        donor candidates). Read-only live view."""
        return self._donor_count.keys()

    def jobs_on(self, gpu: int) -> List[int]:
        return list(self.occupancy[gpu])

    @staticmethod
    def _pick_from_buckets(buckets, k: int) -> List[int]:
        """Take GPUs bucket-by-bucket (id-ascending within a bucket)
        until ``k`` are picked; may return < k (caller checks)."""
        picked: List[int] = []
        for _, gpus in buckets:
            for g in sorted(gpus):
                picked.append(g)
                if len(picked) == k:
                    return picked
        return picked

    def consolidated_pick(self, candidates: List[int], k: int) -> List[int]:
        """Pick ``k`` GPUs from ``candidates`` packed onto as few servers as
        possible (the paper's 'as consolidated on the nodes as possible')."""
        by_server: Dict[int, List[int]] = {}
        for g in candidates:
            by_server.setdefault(self.server_of(g), []).append(g)
        # Prefer servers with the most candidate GPUs; stable by server id.
        order = sorted(by_server.items(), key=lambda kv: (-len(kv[1]), kv[0]))
        return self._pick_from_buckets(order, k)

    def consolidated_pick_free(self, k: int) -> List[int]:
        """``consolidated_pick(free_gpus(), k)`` off the per-server free
        index. The common case (the request fits on the single
        most-free server) is one ``argmax`` over the flat
        free-count array; the multi-server spill sorts server ids by
        ``(-count, sid)`` with one C-level ``lexsort``. Both reproduce
        the original bucket order exactly."""
        fbs = self._free_by_server
        cnt = self._free_count
        # first max == smallest server id among ties, the bucket head
        m = int(cnt.argmax())
        if cnt[m] >= k > 0:
            if k == 1:
                return [min(fbs[m])]
            return sorted(fbs[m])[:k]
        order = _np.lexsort((_np.arange(self.n_servers), -cnt))
        buckets = ((int(sid), fbs[sid]) for sid in order if cnt[sid])
        return self._pick_from_buckets(buckets, k)

    def smallest_free(self, k: int) -> List[int]:
        """The ``k`` smallest free GPU ids — ``free_gpus()[:k]`` without
        materializing (and sorting) the whole free list; the sharing
        placement only ever needs a few fill GPUs."""
        free = self._free
        if k <= 0:
            return []
        if k >= len(free):
            return sorted(free)
        if len(free) > 64:
            arr = _np.fromiter(free, dtype=_np.int64, count=len(free))
            head = _np.partition(arr, k - 1)[:k]
            head.sort()
            return head.tolist()
        return sorted(free)[:k]

    def allocate(self, jid: int, gpus: FrozenSet[int]) -> None:
        # the single-occupancy transitions inline _mark_single /
        # _unmark_single: allocate/release run once per placement at
        # datacenter scale and the call overhead dominates
        occupancy = self.occupancy
        free = self._free
        fbs = self._free_by_server
        fc = self._free_count
        gps = self.gpus_per_server
        max_jobs = self.max_jobs_per_gpu
        single = self._single
        owner = self._single_owner
        dcount = self._donor_count
        flat = self._flat
        for g in gpus:
            occ = occupancy[g]
            n = len(occ)
            if n >= max_jobs:
                raise RuntimeError(f"GPU {g} already holds {occ}")
            occ.append(jid)
            if n == 0:
                free.discard(g)
                sid = g // gps
                fbs[sid].discard(g)
                fc[sid] -= 1
                single.add(g)
                owner[g] = jid
                dcount[jid] = count = dcount.get(jid, 0) + 1
                if flat is not None:
                    flat.set_donor_singles(jid, count)
            elif n == 1:
                single.discard(g)
                prev = owner.pop(g)
                left = dcount[prev] - 1
                if left:
                    dcount[prev] = left
                else:
                    del dcount[prev]
                if flat is not None:
                    flat.set_donor_singles(prev, left)
        self._version += 1

    def release(self, jid: int, gpus: FrozenSet[int]) -> None:
        occupancy = self.occupancy
        free = self._free
        fbs = self._free_by_server
        fc = self._free_count
        gps = self.gpus_per_server
        single = self._single
        owner = self._single_owner
        dcount = self._donor_count
        flat = self._flat
        for g in gpus:
            occ = occupancy[g]
            if jid not in occ:
                raise RuntimeError(f"GPU {g} does not hold job {jid}")
            occ.remove(jid)
            n = len(occ)
            if n == 0:
                single.discard(g)
                prev = owner.pop(g)
                left = dcount[prev] - 1
                if left:
                    dcount[prev] = left
                else:
                    del dcount[prev]
                if flat is not None:
                    flat.set_donor_singles(prev, left)
                free.add(g)
                sid = g // gps
                fbs[sid].add(g)
                fc[sid] += 1
            elif n == 1:
                # the surviving tenant becomes the sole owner
                surv = occ[0]
                single.add(g)
                owner[g] = surv
                dcount[surv] = count = dcount.get(surv, 0) + 1
                if flat is not None:
                    flat.set_donor_singles(surv, count)
        self._version += 1

    # -- failure-aware availability ------------------------------------ #
    @property
    def down_servers(self) -> Set[int]:
        """Servers currently failed. Read-only live view."""
        return self._down_servers

    def server_gpus(self, sid: int) -> range:
        lo = sid * self.gpus_per_server
        return range(lo, lo + self.gpus_per_server)

    def set_server_down(self, sid: int) -> None:
        """Remove a (fully vacated) server's GPUs from the allocatable
        pool. Callers must have released every tenant first: the engine
        fails resident jobs before downing the server."""
        if sid in self._down_servers:
            raise RuntimeError(f"server {sid} already down")
        for g in self.server_gpus(sid):
            if self.occupancy[g]:
                raise RuntimeError(
                    f"cannot down server {sid}: GPU {g} still holds "
                    f"{self.occupancy[g]}")
            self._free.discard(g)
        self._free_by_server[sid].clear()
        self._free_count[sid] = 0
        self._down_servers.add(sid)
        self._version += 1

    def set_server_up(self, sid: int) -> None:
        """Return a recovered server's GPUs to the free pool."""
        if sid not in self._down_servers:
            raise RuntimeError(f"server {sid} is not down")
        self._down_servers.discard(sid)
        fbs = self._free_by_server[sid]
        for g in self.server_gpus(sid):
            self._free.add(g)
            fbs.add(g)
        self._free_count[sid] = self.gpus_per_server
        self._version += 1

    def co_runners(self, job: Job) -> Set[int]:
        others: Set[int] = set()
        for g in job.placement:
            for j in self.occupancy[g]:
                if j != job.jid:
                    others.add(j)
        return others
