"""Job and cluster state for the scheduling model (Section IV); the
port's copy of the reference's ``core/job.py``, without the hooks of its
vectorized decision paths, which the port does not carry."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set

from .perf_model import PerfParams


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
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
    preemptions: int = 0        # re-queues (by a fault, in the port)
    failures: int = 0           # injected faults that killed an attempt
    lost_iters: float = 0.0     # work rolled back to the last checkpoint
    waiting_time: float = 0.0   # total time not holding GPUs (queue + re-queued)
    # memos: solo_t_iter keyed by sub_batch, t_iter keyed by the candidate
    # sub-batch (scheduler sort keys and Algorithm-2 sub-batch sweeps hit
    # these on every pass), and the solo-fit sub-batch per capacity
    _t_iter_memo: Optional[tuple] = field(
        default=None, repr=False, compare=False)
    _t_iter_by_b: Dict[int, float] = field(
        default_factory=dict, repr=False, compare=False)
    _ert_memo: Optional[tuple] = field(
        default=None, repr=False, compare=False)
    _solo_sub_memo: Dict[float, Optional[int]] = field(
        default_factory=dict, repr=False, compare=False)

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

    def t_iter_sub(self, sub_batch: int) -> float:
        """Memoized ``perf.t_iter_sub(batch, sub_batch)``: the
        Algorithm-2 sweep re-evaluates the same few candidate sub-batches
        for a job on every scheduling pass."""
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

    def jct(self) -> float:
        if self.finish_time is None:
            raise RuntimeError(f"job {self.jid} not finished")
        return self.finish_time - self.arrival

    def queueing_delay(self) -> float:
        """Total time spent without GPUs (initial queueing + time spent
        re-queued after a fault) — the paper's 'queuing delay'."""
        return self.waiting_time


@dataclass
class ClusterState:
    """Servers x GPUs with <= C jobs per GPU (C=2 in the paper).

    The free set, single-occupancy set and per-server free sets are
    maintained as O(1) updates per GPU inside :meth:`allocate`/:meth:`release`; the sorted
    list views handed to schedulers are materialized lazily from the sets
    (cached per occupancy version), in id order.
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
    # servers currently failed: their GPUs are out of the free pool until
    # the matching recover event
    _down_servers: Set[int] = field(
        default_factory=set, repr=False, compare=False)

    def __post_init__(self) -> None:
        for g in range(self.n_gpus):
            self.occupancy.setdefault(g, [])
        self._free_by_server = [set() for _ in range(self.n_servers)]
        for g in range(self.n_gpus):
            occ = self.occupancy[g]
            if not occ:
                self._free.add(g)
                self._free_by_server[self.server_of(g)].add(g)
            elif len(occ) == 1:
                self._single.add(g)

    @property
    def n_gpus(self) -> int:
        return self.n_servers * self.gpus_per_server

    @property
    def n_free(self) -> int:
        return len(self._free)

    def server_of(self, gpu: int) -> int:
        return gpu // self.gpus_per_server

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

    def consolidated_pick_free(self, k: int) -> List[int]:
        """Pick ``k`` free GPUs packed onto as few servers as possible (the
        paper's 'as consolidated on the nodes as possible'): servers by
        (-free count, id), GPUs by id within each."""
        order = sorted(
            ((sid, gpus) for sid, gpus in enumerate(self._free_by_server)
             if gpus),
            key=lambda kv: (-len(kv[1]), kv[0]))
        return self._pick_from_buckets(order, k)

    def allocate(self, jid: int, gpus: FrozenSet[int]) -> None:
        occupancy = self.occupancy
        for g in gpus:
            occ = occupancy[g]
            n = len(occ)
            if n >= self.max_jobs_per_gpu:
                raise RuntimeError(f"GPU {g} already holds {occ}")
            occ.append(jid)
            if n == 0:
                self._free.discard(g)
                self._free_by_server[self.server_of(g)].discard(g)
                self._single.add(g)
            elif n == 1:
                self._single.discard(g)
        self._version += 1

    def release(self, jid: int, gpus: FrozenSet[int]) -> None:
        occupancy = self.occupancy
        for g in gpus:
            occ = occupancy[g]
            if jid not in occ:
                raise RuntimeError(f"GPU {g} does not hold job {jid}")
            occ.remove(jid)
            n = len(occ)
            if n == 0:
                self._single.discard(g)
                self._free.add(g)
                self._free_by_server[self.server_of(g)].add(g)
            elif n == 1:
                # the surviving tenant becomes the sole owner
                self._single.add(g)
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
        self._version += 1

    def co_runners(self, job: Job) -> Set[int]:
        others: Set[int] = set()
        for g in job.placement:
            for j in self.occupancy[g]:
                if j != job.jid:
                    others.add(j)
        return others
