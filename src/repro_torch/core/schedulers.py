"""Scheduling policies of Section VI-A, the port's copy of the
reference's ``core/schedulers.py`` with the same arithmetic in the same
order:

* FIFO           — strict arrival order, exclusive GPUs, head-of-line blocks.
* SJF            — shortest-remaining-solo-time first, exclusive GPUs.
* Tiresias       — preemptive discretized-2Q LAS (attained service =
                   gpus x seconds), restart penalty on resume.
* PolluxLike     — preemptive elastic baseline: periodic marginal-gain GPU
                   reallocation on each job's speedup curve (user batch kept
                   fixed).
* SJF-FFS        — SJF + aggressive first-fit GPU sharing (no benefit check).
* SJF-BSBF       — the paper's Algorithm 1 (+ Algorithm 2 / Theorem 1).
"""
from __future__ import annotations

from bisect import insort
from typing import Dict, List, Optional, Tuple

import numpy as np

from .batch_scaling import (best_sharing_config,
                            best_sharing_config_donor_scaled,
                            candidate_sub_batches)
from .job import Job, JobState
from .perf_model import t_iter_at_workers
from .pair_batch import DonorBatch, best_sharing_configs
from .pass_batch import GridPass
from .simulator import SchedulerBase, Simulator, check_decision

__all__ = ["ALL_POLICIES", "FIFO", "SJF", "SJF_BSBF", "SJF_FFS", "SRSF",
           "PolluxLike", "Tiresias", "make_scheduler", "shared_sub_batch",
           "solo_sub_batch"]


# ---------------------------------------------------------------------- #
# helpers
# ---------------------------------------------------------------------- #
def solo_sub_batch(job: Job, capacity: float) -> Optional[int]:
    """Largest candidate sub-batch that fits device memory alone
    (gradient accumulation supplies the rest). Memoized per (job,
    capacity): ``_start_exclusive`` re-asks for the same head-of-line
    job on every scheduling pass."""
    memo = job._solo_sub_memo
    try:
        return memo[capacity]
    except KeyError:
        pass
    sub = None
    for b in candidate_sub_batches(job.batch):
        if job.perf.fits(b, capacity):
            sub = b
            break
    memo[capacity] = sub
    return sub


def shared_sub_batch(job: Job, capacity: float, other_mem: float) -> Optional[int]:
    for b in candidate_sub_batches(job.batch):
        if job.perf.fits(b, capacity, other_mem=other_mem):
            return b
    return None


class _StaticOrder:
    """Incrementally maintained sorted view over the scheduler's job
    queue, for policies whose per-job sort key is *static* while the job
    sits in that queue (non-preemptive SJF variants: a pending job's
    remaining work is frozen; Tiresias/FIFO arrival order never
    changes). Jobs are inserted once with their key via ``bisect``;
    departed jobs are skipped lazily and only *terminal* (finished)
    entries are compacted away. Produces exactly the order
    ``sorted(queue, key)`` would (keys are tie-broken by jid, so
    comparison never reaches the Job object).

    A job re-entering the queue after a preemption may carry a changed
    key; each entry therefore remembers the job's preemption count and
    the view re-keys itself when they disagree. Policies whose key
    cannot change across requeues (arrival order) pass
    ``requeue_safe=True`` to skip that check.

    ``terminal_states`` controls which entries compaction may drop.
    Policies that only ever order the *pending* queue can include
    ``RUNNING`` (the entry is removed from tracking, so a preempted job
    re-enters via ``insort`` with a fresh key) — at datacenter scale the
    running population dwarfs the queue, and keeping those entries makes
    every ``order()`` call O(running)."""

    def __init__(self, key_fn, live_states=(JobState.PENDING,),
                 requeue_safe=False,
                 terminal_states=(JobState.FINISHED,)):
        self._key_fn = key_fn
        self._live = live_states
        self._requeue_safe = requeue_safe
        self._terminal = terminal_states
        self._entries: List[tuple] = []   # (key, jid, job, preemptions)
        self._tracked: set = set()
        self._compact_backoff = 0   # calls to skip after a no-op compaction

    def reset(self) -> None:
        self._entries.clear()
        self._tracked.clear()
        self._compact_backoff = 0

    def _rekey(self) -> List[tuple]:
        key_fn = self._key_fn
        terminal = self._terminal
        alive = [e[2] for e in self._entries
                 if e[2].state not in terminal]
        self._entries = sorted(
            (key_fn(j), j.jid, j, j.preemptions) for j in alive)
        self._tracked = {j.jid for j in alive}
        return self._entries

    def order(self, *queues) -> List[Job]:
        entries, tracked, key_fn = self._entries, self._tracked, self._key_fn
        if not entries and not any(queues):
            return []   # idle pass (most events at datacenter scale)
        for queue in queues:
            for job in queue:
                jid = job.jid
                if jid not in tracked:
                    tracked.add(jid)
                    insort(entries, (key_fn(job), jid, job,
                                     job.preemptions))
        live = self._live
        if self._requeue_safe:
            out = [e[2] for e in entries if e[2].state in live]
        else:
            out = []
            for e in entries:
                job = e[2]
                if job.state in live:
                    if job.preemptions != e[3]:
                        # re-queued since insertion: key may be stale
                        entries = self._rekey()
                        out = [e[2] for e in entries
                               if e[2].state in live]
                        break
                    out.append(job)
        if 2 * len(out) < len(entries):
            if self._compact_backoff > 0:
                self._compact_backoff -= 1
            else:
                terminal = self._terminal
                keep = [e for e in entries
                        if e[2].state not in terminal]
                if len(keep) < len(entries):
                    self._entries = keep
                    self._tracked = {e[1] for e in keep}
                else:
                    # nothing terminal to drop (entries are mostly
                    # RUNNING); back off so the no-op rescan amortizes
                    # to O(1) per call instead of O(entries)
                    self._compact_backoff = max(8, len(entries) >> 3)
        return out


def _start_exclusive(sim: Simulator, job: Job) -> bool:
    cluster = sim.cluster
    want = job.alloc_gpus or job.gpus
    if cluster.n_free < want:
        return False
    sub = solo_sub_batch(job, cluster.gpu_capacity_bytes)
    if sub is None:
        raise RuntimeError(f"job {job.jid} cannot fit memory even at b=1")
    gpus = cluster.consolidated_pick_free(want)
    sim.start_job(job, gpus, sub_batch=sub)
    return True


# ---------------------------------------------------------------------- #
class FIFO(SchedulerBase):
    name = "fifo"
    reads_running_progress = False

    def schedule(self, sim: Simulator) -> None:
        # pending is already in (arrival, jid) order: arrivals append in
        # that order and nothing re-enters the queue
        for job in list(sim.pending):
            if not _start_exclusive(sim, job):
                break  # strict FIFO: head-of-line blocks the queue


class SJF(SchedulerBase):
    """Shortest-job-first, exclusive GPUs, strict priority order: if the
    currently-shortest job cannot be placed, later jobs wait (no backfill —
    matching the queueing structure the paper reports for SJF)."""

    name = "sjf"
    reads_running_progress = False

    def __init__(self) -> None:
        # orders only the pending queue, so started jobs are compactable
        self._order = _StaticOrder(
            lambda j: j.expected_remaining_time,
            terminal_states=(JobState.RUNNING, JobState.FINISHED))

    def reset(self) -> None:
        self._order.reset()

    def schedule(self, sim: Simulator) -> None:
        # every PENDING job is in sim.pending, so an empty queue means
        # nothing to place (most finish events at datacenter scale)
        if not sim.pending:
            return
        for job in self._order.order(sim.pending):
            if not _start_exclusive(sim, job):
                break


# ---------------------------------------------------------------------- #
class Tiresias(SchedulerBase):
    """Discretized two-queue least-attained-service, preemptive."""

    name = "tiresias"
    preemptive = True

    def __init__(self, threshold_gpu_seconds: float = 3600.0,
                 tick_interval: float = 60.0) -> None:
        self.threshold = threshold_gpu_seconds
        self.tick_interval = tick_interval
        self._active = _StaticOrder(
            lambda j: (j.arrival, j.jid),
            live_states=(JobState.PENDING, JobState.RUNNING),
            requeue_safe=True)   # arrival order survives preemption

    def reset(self) -> None:
        self._active.reset()

    def schedule(self, sim: Simulator) -> None:
        # every job enters via the pending queue, so tracking it is
        # enough to enumerate all active jobs in (arrival, jid) order
        active = self._active.order(sim.pending)
        if not active:
            return
        # == sorted(active, key=(queue, arrival, jid)): the threshold
        # partition preserves the static arrival order within each queue
        thr = self.threshold
        order = ([j for j in active if j.attained_service < thr]
                 + [j for j in active if j.attained_service >= thr])
        total = sim.cluster.n_gpus
        chosen: List[Job] = []
        cap = total
        for j in order:
            if j.gpus <= cap:
                chosen.append(j)
                cap -= j.gpus
        chosen_ids = {j.jid for j in chosen}
        for j in list(sim.running.values()):
            if j.jid not in chosen_ids:
                sim.preempt_job(j)
        for j in chosen:
            if j.state == JobState.PENDING:
                _start_exclusive(sim, j)


# ---------------------------------------------------------------------- #
class SRSF(SchedulerBase):
    """Clairvoyant shortest-remaining-service-first (the policy Tiresias
    approximates without duration knowledge; Tiresias paper shows SRSF is
    near-optimal when durations are known). Preemptive: whenever a job
    with smaller remaining service (gpus x remaining seconds) arrives, it
    may evict enough larger jobs to run."""

    name = "srsf"
    preemptive = True

    def schedule(self, sim: Simulator) -> None:
        active: List[Job] = list(sim.running.values()) + list(sim.pending)
        if not active:
            return
        service = lambda j: j.gpus * j.expected_remaining_time
        order = sorted(active, key=lambda j: (service(j), j.jid))
        cap = sim.cluster.n_gpus
        chosen: List[Job] = []
        for j in order:
            if j.gpus <= cap:
                chosen.append(j)
                cap -= j.gpus
        chosen_ids = {j.jid for j in chosen}
        for j in list(sim.running.values()):
            if j.jid not in chosen_ids:
                sim.preempt_job(j)
        for j in chosen:
            if j.state == JobState.PENDING:
                _start_exclusive(sim, j)


# ---------------------------------------------------------------------- #
class PolluxLike(SchedulerBase):
    """Elastic preemptive baseline: every tick, reassign GPU counts by
    greedy marginal goodput gain, capped at each job's requested G_k
    (the real Pollux can also overshoot and retune batch size; we keep the
    user batch to mirror the accuracy-preserving comparison in the paper)."""

    name = "pollux"
    preemptive = True
    tick_only = True   # real Pollux acts on a fixed optimization interval
    reads_running_progress = False   # _rate() uses static perf fields only

    def __init__(self, tick_interval: float = 60.0,
                 min_gpus: int = 1) -> None:
        self.tick_interval = tick_interval
        self.min_gpus = min_gpus
        self._rate_cache: Dict[Tuple[int, int, int], float] = {}
        self._levels_cache: Dict[int, List[int]] = {}
        # (jid, accum_steps, cur_level) -> (marginal gain, next level),
        # or None when the job is already at its top level
        self._gain_cache: Dict[Tuple[int, int, int], object] = {}

    def reset(self) -> None:
        self._rate_cache.clear()   # jids are only unique within one run
        self._gain_cache.clear()

    def _rate(self, job: Job, n: int) -> float:
        """User-iterations/sec at allocation n (weak scaling). Memoized:
        the greedy upgrade loop re-evaluates the same (job, n) points
        thousands of times per tick on large traces."""
        key = (job.jid, job.accum_steps, n)
        cached = self._rate_cache.get(key)
        if cached is not None:
            return cached
        if n <= 0:
            val = 0.0
        else:
            t_phys = t_iter_at_workers(job.perf, job.batch,
                                       job.accum_steps, n)
            val = (n / job.gpus) / t_phys
        self._rate_cache[key] = val
        return val

    def _levels(self, job: Job) -> List[int]:
        levels = self._levels_cache.get(job.gpus)
        if levels is None:
            levels = [n for n in (1, 2, 4, 8, 12, 16, 24, 32)
                      if n <= job.gpus] or [job.gpus]
            self._levels_cache[job.gpus] = levels
        return levels

    def _gain(self, job: Job, cur: int):
        """(marginal goodput gain, next level) above ``cur`` — pure in
        (job, accum_steps, cur), so cached across upgrade rounds and
        ticks; None when no higher level exists."""
        key = (job.jid, job.accum_steps, cur)
        try:
            return self._gain_cache[key]
        except KeyError:
            pass
        nxt = None
        for n in self._levels(job):
            if n > cur:
                nxt = n
                break
        if nxt is None:
            val = None
        else:
            val = ((self._rate(job, nxt) - self._rate(job, cur))
                   / (nxt - cur), nxt)
        self._gain_cache[key] = val
        return val

    def schedule(self, sim: Simulator) -> None:
        active: List[Job] = list(sim.running.values()) + list(sim.pending)
        if not active:
            return
        total = sim.cluster.n_gpus
        # Fair-share allocation in powers of two up to G_k (Pollux optimizes
        # goodput *subject to fairness*; fair shares, then goodput-aware
        # upgrades for whoever is furthest below its request).
        alloc: Dict[int, int] = {j.jid: 0 for j in active}
        levels = self._levels
        budget = total
        order = sorted(active, key=lambda j: (j.arrival, j.jid))
        for j in order:
            first = levels(j)[0]
            if budget >= first:
                alloc[j.jid] = first
                budget -= first
        # Greedy upgrades: furthest below fair share first; break ties by
        # marginal rate, then jid (same selection as sorting all
        # candidates and taking the head). A job whose next level does
        # not exist or exceeds the remaining budget can never become
        # upgradeable again this tick (budget only shrinks and its
        # allocation is frozen until upgraded), so it is pruned from the
        # scan instead of being re-evaluated every round.
        gain_of = self._gain
        live = [j for j in active if alloc[j.jid] > 0]
        while budget > 0 and live:
            best = None
            still = []
            for j in live:
                cur = alloc[j.jid]
                g = gain_of(j, cur)
                if g is None or g[1] - cur > budget:
                    continue
                still.append(j)
                key = (cur / j.gpus, -g[0], j.jid)
                if best is None or key < best[0]:
                    best = (key, j, g[1])
            live = still
            if best is None:
                break
            _, j, nxt = best
            budget -= nxt - alloc[j.jid]
            alloc[j.jid] = nxt

        # Apply: preempt mismatched running jobs, then start.
        for j in list(sim.running.values()):
            if alloc.get(j.jid, 0) != (j.alloc_gpus or j.gpus):
                sim.preempt_job(j)
        for j in sorted(sim.pending, key=lambda x: (x.arrival, x.jid)):
            n = alloc.get(j.jid, 0)
            if n <= 0:
                continue
            if sim.cluster.n_free < n:
                continue
            j.alloc_gpus = n
            sub = solo_sub_batch(j, sim.cluster.gpu_capacity_bytes)
            gpus = sim.cluster.consolidated_pick_free(n)
            sim.start_job(j, gpus, sub_batch=sub)


# ---------------------------------------------------------------------- #
class SJF_FFS(SchedulerBase):
    """SJF + first-fit sharing: when free GPUs are insufficient, greedily
    take single-occupancy GPUs (no Theorem-1 benefit check) — the paper's
    comparison baseline showing that *wise* sharing matters."""

    name = "sjf-ffs"
    reads_running_progress = False   # pairs on static mem/perf fields only

    def __init__(self) -> None:
        self._order = _StaticOrder(
            lambda j: j.expected_remaining_time,
            terminal_states=(JobState.RUNNING, JobState.FINISHED))

    def reset(self) -> None:
        self._order.reset()

    def schedule(self, sim: Simulator) -> None:
        if not sim.pending:   # nothing to place (see SJF.schedule)
            return
        cap = sim.cluster.gpu_capacity_bytes
        for job in self._order.order(sim.pending):
            if _start_exclusive(sim, job):
                continue
            free = sim.cluster.free_gpus()
            singles = sim.cluster.single_occupancy_gpus()
            if len(free) + len(singles) < job.gpus:
                continue
            # first fit: free GPUs first, then single-occupancy in id order
            chosen = list(free)
            max_other_mem = 0.0
            for g in singles:
                if len(chosen) >= job.gpus:
                    break
                other = sim.jobs[sim.cluster.occupancy[g][0]]
                max_other_mem = max(
                    max_other_mem, other.perf.mem_bytes(other.sub_batch))
                chosen.append(g)
            if len(chosen) < job.gpus:
                continue
            chosen = chosen[:job.gpus]
            sub = shared_sub_batch(job, cap, max_other_mem)
            if sub is None:
                continue  # does not fit next to the co-runners
            sim.start_job(job, chosen, sub_batch=sub)


# ---------------------------------------------------------------------- #
class SJF_BSBF(SchedulerBase):
    """Algorithm 1: Shortest Job First with Best Sharing Benefit First.

    Three decision paths with identical event logs:

    * ``scalar`` (the port's default) — the per-(pending, donor)
      :func:`best_sharing_config` loop.
    * ``grid`` — one vectorized pass over the whole pending queue
      (:class:`core.pass_batch.GridPass`): Algorithm 2 / Theorem 1
      evaluated for all pending jobs x all donors in one NumPy grid over
      flat preallocated tables, placements walked with a masked
      ``(key, jid)`` argmin.
    * ``batched`` — one :func:`core.pair_batch.best_sharing_configs`
      call per pending job evaluates Algorithm 2 against every donor as
      NumPy array ops; the donor batch is reused until a placement or a
      reconfiguration changes a donor.

    The path comes from the constructor, else the Simulator's
    ``decision_path`` (its ``decision=`` argument, default scalar).
    All paths read donor progress *virtually* via
    ``Simulator.remaining_at`` (no pre-pass accrual sweep), hence
    ``reads_running_progress = False``.

    ``donor_reconfig=True`` enables the Algorithm-2 extension: when no
    donor admits the new job at its current footprint, the donor's own
    sub-batch is swept down too
    (:func:`core.batch_scaling.best_sharing_config_donor_scaled`)
    and, when the benefit survives the donor's slowdown, the donor is
    reconfigured mid-run via ``Simulator.reconfigure_job`` at the
    sharing time point. Forces the scalar decision path; default off —
    the paper's Algorithm 1 never retunes a running job.
    """

    name = "sjf-bsbf"
    # donor remaining work is read virtually (Simulator.remaining_at),
    # so the engine's pre-schedule accrual sweep is skipped entirely
    reads_running_progress = False
    progress_scope = "donors"   # schedule() only reads donors' progress

    def __init__(self, decision: Optional[str] = None,
                 donor_reconfig: bool = False) -> None:
        self._order = _StaticOrder(
            lambda j: j.expected_remaining_time,
            terminal_states=(JobState.RUNNING, JobState.FINISHED))
        check_decision(decision)
        self.donor_reconfig = donor_reconfig
        if donor_reconfig and decision is None:
            decision = "scalar"   # extension lives on the scalar path
        if donor_reconfig and decision in ("grid", "batched"):
            raise ValueError("donor_reconfig requires decision='scalar'")
        self.decision = decision
        # ((cluster version, reconfigurations), DonorBatch): donor
        # membership changes with placements, and a donor's memory and
        # iteration time with placements and reconfigurations, so the
        # batch (and its per-model xi cache) survives across scheduling
        # passes until either moves
        self._donor_cache: Optional[tuple] = None
        self._grid: Optional[object] = None   # per-sim GridPass

    def reset(self) -> None:
        self._order.reset()
        self._donor_cache = None
        self._grid = None

    def schedule(self, sim: Simulator) -> None:
        # every PENDING job is in sim.pending, so an empty queue means
        # nothing to place (most finish events at datacenter scale);
        # arrivals never skip the queue, so no ingest can be missed
        if not sim.pending:
            return
        path = self.decision or sim.decision_path
        if path == "grid":
            self._schedule_grid(sim)
        elif path == "batched":
            self._schedule_batched(sim)
        else:
            self._schedule_scalar(sim)

    # -- vectorized whole-pass path ------------------------------------ #
    def _schedule_grid(self, sim: Simulator) -> None:
        state = self._grid
        if state is None or state.sim is not sim:
            state = self._grid = GridPass(sim)
        state.schedule(sim, _start_exclusive)

    # -- batched decision path ----------------------------------------- #
    def _schedule_batched(self, sim: Simulator) -> None:
        cluster = sim.cluster
        cap = cluster.gpu_capacity_bytes
        jobs = sim.jobs
        occupancy = cluster.occupancy
        # virtual read of donor remaining work — no accrual sweep needed
        rem_of = sim.remaining_at
        donor_batch = None   # rebuilt after any placement changes donors
        for job in self._order.order(sim.pending):
            # Lines 6-8: enough free GPUs -> exclusive consolidated pick.
            if _start_exclusive(sim, job):
                donor_batch = None
                continue
            free = cluster.free_gpus()
            if len(free) + cluster.n_single < job.gpus:
                continue  # Line 9 fails: stay pending
            # Lines 10-13: Algorithm 2 against every donor in one shot.
            if donor_batch is None:
                stamp = (cluster.version, sim.engine.reconfigs_total)
                cached = self._donor_cache
                if cached is not None and cached[0] == stamp:
                    donor_batch = cached[1]
                    donor_batch.refresh_progress(rem_of)
                else:
                    donor_batch = DonorBatch(
                        [jobs[j] for j in sorted(cluster.donor_jids())],
                        rem_fn=rem_of)
                    self._donor_cache = (stamp, donor_batch)
            res = best_sharing_configs(job, donor_batch,
                                       sim.interference, cap)
            idx = np.flatnonzero(res.share)
            if idx.size == 0:
                continue  # SF False for all pairs: defer (stay in pool)
            # Line 14: donors by pair-JCT ascending, ties by jid (the
            # scalar sort key).
            order = idx[np.lexsort((donor_batch.jids[idx],
                                    res.avg_jct[idx]))]
            # Lines 15-17: take donors' GPUs until the request is met
            # (shared GPUs first — they pace the job — then free ones).
            chosen: List[int] = []
            sub = job.batch
            for i in order:
                if len(chosen) >= job.gpus:
                    break
                run = donor_batch.donors[i]
                for g in sorted(run.placement):
                    if len(occupancy[g]) == 1:
                        chosen.append(g)
                        if len(chosen) >= job.gpus:
                            break
                sub = min(sub, int(res.sub_batch[i]))
            if len(chosen) < job.gpus:
                chosen.extend(free[: job.gpus - len(chosen)])
            if len(chosen) < job.gpus:
                continue
            chosen = chosen[:job.gpus]
            sim.start_job(job, chosen, sub_batch=sub)
            donor_batch = None

    # -- scalar decision path ------------------------------------------ #
    def _schedule_scalar(self, sim: Simulator) -> None:
        cap = sim.cluster.gpu_capacity_bytes
        # virtual read of donor remaining work — no accrual sweep needed
        rem_of = sim.remaining_at
        for job in self._order.order(sim.pending):
            # Lines 6-8: enough free GPUs -> exclusive consolidated pick.
            if _start_exclusive(sim, job):
                continue
            free = sim.cluster.free_gpus()
            singles = sim.cluster.single_occupancy_gpus()
            if len(free) + len(singles) < job.gpus:
                continue  # Line 9 fails: stay pending
            # Lines 10-13: evaluate every running job owning single-occupancy
            # GPUs with Algorithm 2; keep those with sharing benefit.
            donor_jids = {sim.cluster.occupancy[g][0] for g in singles}
            donors = []
            blocked = []   # donors with NO memory-feasible sub-batch
            for jid in donor_jids:
                run = sim.jobs[jid]
                cfg = best_sharing_config(
                    run, job, sim.interference, cap,
                    rem_run=rem_of(run))
                if cfg.share:
                    donors.append((cfg, run))
                elif cfg.decision is None:
                    blocked.append(jid)
            if not donors and blocked and self.donor_reconfig:
                # only memory-blocked donors are worth the double sweep:
                # a donor that already fit but lost Theorem 1 can only
                # get slower by shrinking its own sub-batch
                if self._share_with_donor_reconfig(sim, job, blocked,
                                                   cap, free):
                    continue
            if not donors:
                continue  # SF False for all pairs: defer (put back in pool)
            # Line 14: sort candidate pairs by pair-JCT ascending.
            donors.sort(key=lambda t: (t[0].avg_jct, t[1].jid))
            # Lines 15-17: take donors' GPUs until the request is met
            # (shared GPUs first — they pace the job — then free ones).
            chosen: List[int] = []
            sub = job.batch
            for cfg, run in donors:
                if len(chosen) >= job.gpus:
                    break
                for g in sorted(run.placement):
                    if len(sim.cluster.occupancy[g]) == 1:
                        chosen.append(g)
                        if len(chosen) >= job.gpus:
                            break
                sub = min(sub, cfg.sub_batch)
            if len(chosen) < job.gpus:
                chosen.extend(free[: job.gpus - len(chosen)])
            if len(chosen) < job.gpus:
                continue
            chosen = chosen[:job.gpus]
            sim.start_job(job, chosen, sub_batch=sub)

    # -- donor-rescaling extension -------------------------------------- #
    def _share_with_donor_reconfig(self, sim: Simulator, job: Job,
                                   donor_jids, cap: float,
                                   free: List[int]) -> bool:
        """No donor admits ``job`` at its current footprint: retry each
        donor with its own sub-batch swept down, pick the best benefit,
        place the new job on that donor's single-occupancy GPUs (plus
        free ones) and reconfigure the donor mid-run. Single-donor only:
        a request spanning several reconfigured donors is deferred."""
        best = None
        for jid in sorted(donor_jids):
            run = sim.jobs[jid]
            cfg = best_sharing_config_donor_scaled(
                run, job, sim.interference, cap,
                rem_run=sim.remaining_at(run))
            if cfg.share and (best is None or cfg.avg_jct < best[0].avg_jct):
                best = (cfg, run)
        if best is None:
            return False
        cfg, run = best
        chosen = [g for g in sorted(run.placement)
                  if len(sim.cluster.occupancy[g]) == 1][:job.gpus]
        if len(chosen) < job.gpus:
            chosen.extend(free[: job.gpus - len(chosen)])
        if len(chosen) < job.gpus:
            return False
        sim.reconfigure_job(run, cfg.donor_sub_batch)
        sim.start_job(job, chosen[:job.gpus], sub_batch=cfg.sub_batch)
        return True


ALL_POLICIES = {
    "fifo": FIFO,
    "sjf": SJF,
    "srsf": SRSF,
    "tiresias": Tiresias,
    "pollux": PolluxLike,
    "sjf-ffs": SJF_FFS,
    "sjf-bsbf": SJF_BSBF,
}


def make_scheduler(name: str, **kwargs) -> SchedulerBase:
    try:
        return ALL_POLICIES[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; "
                         f"choose from {sorted(ALL_POLICIES)}") from None
