"""SJF-BSBF, the paper's Algorithm 1 (+ Algorithm 2 / Theorem 1): the
port's copy of the reference's ``core/schedulers.py`` policy with its
scalar decision path and the helpers it calls, same arithmetic.
"""
from __future__ import annotations

from bisect import insort
from typing import List, Optional

from .batch_scaling import (best_sharing_config,
                            best_sharing_config_donor_scaled,
                            candidate_sub_batches)
from .job import Job, JobState
from .simulator import SchedulerBase, Simulator

__all__ = ["SJF_BSBF", "shared_sub_batch", "solo_sub_batch"]


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
    """Incrementally maintained sorted view over the pending queue, for a
    non-preemptive SJF policy whose per-job sort key is static while the
    job waits (its remaining work is frozen). Jobs are inserted once with
    their key via ``bisect``; started jobs are skipped and compacted away
    lazily. Produces exactly the order ``sorted(queue, key)`` would (keys
    are tie-broken by jid, so comparison never reaches the Job object).

    A job re-entering the queue after a failure may carry a changed key;
    each entry remembers the job's preemption count and the view re-keys
    itself when they disagree."""

    _live = (JobState.PENDING,)
    _terminal = (JobState.RUNNING, JobState.FINISHED)

    def __init__(self, key_fn):
        self._key_fn = key_fn
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
            return []
        for queue in queues:
            for job in queue:
                jid = job.jid
                if jid not in tracked:
                    tracked.add(jid)
                    insort(entries, (key_fn(job), jid, job,
                                     job.preemptions))
        live = self._live
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
                    # nothing terminal to drop; back off so the no-op
                    # rescan amortizes to O(1) per call
                    self._compact_backoff = max(8, len(entries) >> 3)
        return out


def _start_exclusive(sim: Simulator, job: Job) -> bool:
    cluster = sim.cluster
    if cluster.n_free < job.gpus:
        return False
    sub = solo_sub_batch(job, cluster.gpu_capacity_bytes)
    if sub is None:
        raise RuntimeError(f"job {job.jid} cannot fit memory even at b=1")
    gpus = cluster.consolidated_pick_free(job.gpus)
    sim.start_job(job, gpus, sub_batch=sub)
    return True


# ---------------------------------------------------------------------- #
class SJF_BSBF(SchedulerBase):
    """Algorithm 1: Shortest Job First with Best Sharing Benefit First.

    The port carries the reference's scalar decision path, the per-
    (pending, donor) :func:`best_sharing_config` loop; the reference pins
    its vectorized ``grid``/``batched`` paths to the same outcomes. It
    reads donor progress virtually via ``Simulator.remaining_at`` (no
    pre-pass accrual sweep).

    ``donor_reconfig=True`` enables the Algorithm-2 extension: when no
    donor admits the new job at its current footprint, the donor's own
    sub-batch is swept down too
    (:func:`core.batch_scaling.best_sharing_config_donor_scaled`) and,
    when the benefit survives the donor's slowdown, the donor is
    reconfigured mid-run via ``Simulator.reconfigure_job`` at the
    sharing time point. Default off: the paper's Algorithm 1 never
    retunes a running job.
    """

    name = "sjf-bsbf"

    def __init__(self, decision: Optional[str] = None,
                 donor_reconfig: bool = False) -> None:
        if decision not in (None, "scalar"):
            raise ValueError(
                f"decision path {decision!r} is not ported: the port "
                "carries the scalar path only (the reference pins its "
                "'grid' and 'batched' paths to the same schedules)")
        self._order = _StaticOrder(lambda j: j.expected_remaining_time)
        self.donor_reconfig = donor_reconfig

    def reset(self) -> None:
        self._order.reset()

    def schedule(self, sim: Simulator) -> None:
        # every PENDING job is in sim.pending, so an empty queue means
        # nothing to place; arrivals never skip the queue
        if not sim.pending:
            return
        self._schedule_scalar(sim)

    # -- scalar decision path ----------------------------------------- #
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

