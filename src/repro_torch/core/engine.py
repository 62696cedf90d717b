"""The discrete-event engine behind :class:`core.simulator.Simulator`
(the port's copy of the reference's ``core/engine.py``: its
:class:`HeapEngine`, with the same arithmetic in the same order, for a
non-preemptive, tick-free policy such as ``SJF_BSBF``).

An indexed binary heap of predicted finish events with lazy invalidation
(per-job sequence numbers; stale entries are discarded on pop), a dirty
set of jobs whose GPU co-runner sets changed (from ``start_job`` /
``reconfigure_job`` / a fault / release-on-finish) so interference rates
are only recomputed for those, and lazy progress/waiting accrual. The
engine owns the event clock, the pending/running queues and the progress
accounting; the policy-facing :class:`core.simulator.Simulator` proxies
to it.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .job import Job, JobState

_EPS = 1e-9

# A job is complete when its remaining iterations drop below this
# fraction of its total (guards float drift near the finish time).
_FINISH_TOL = 1e-6


@dataclass
class SimResults:
    """Per-run results container.

    Contract on degenerate inputs (the reference's): ``avg_jct`` /
    ``avg_queueing`` return **0.0 when the selection is empty** — an
    empty job list, or a large/small split with no members (e.g. a trace
    with only small jobs asked for ``large=True``). Callers averaging
    averages must treat 0.0-with-empty-selection as "no data", not as a
    measured zero. ``makespan`` is 0.0 for an empty run.
    """

    jobs: List[Job]
    makespan: float
    events: int
    name: str = ""

    # ------------------------------------------------------------------ #
    def _sel(self, large: Optional[bool]) -> List[Job]:
        if large is None:
            return self.jobs
        return [j for j in self.jobs if (j.gpus > 4) == large]

    def avg_jct(self, large: Optional[bool] = None) -> float:
        sel = self._sel(large)
        return sum(j.jct() for j in sel) / len(sel) if sel else 0.0

    def avg_queueing(self, large: Optional[bool] = None) -> float:
        sel = self._sel(large)
        return sum(j.queueing_delay() for j in sel) / len(sel) if sel else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "makespan": self.makespan,
            "avg_jct": self.avg_jct(),
            "avg_jct_large": self.avg_jct(True),
            "avg_jct_small": self.avg_jct(False),
            "avg_queue": self.avg_queueing(),
            "avg_queue_large": self.avg_queueing(True),
            "avg_queue_small": self.avg_queueing(False),
        }


class HeapEngine:
    """Event clock, queues, progress accounting and the indexed heaps.

    Two heaps share one set of live entries, validated by per-job
    sequence numbers (``_entry_seq``):

    * ``_heap``      — keyed by the predicted finish time; drives the
                       next-event clock together with the next arrival
                       and the next fault event.
    * ``_done_heap`` — keyed by the time at which the job's remaining
                       work drops inside the finish tolerance: a job
                       completes at the first event where its remaining
                       work is <= tol, without a per-event sweep.

    Rates are recomputed only for the dirty set, and progress is accrued
    lazily: at rate changes, completion and failure. The policy reads
    donors' remaining work virtually (:meth:`remaining_at`), so no
    accrual sweep precedes a scheduling pass. The constructor pulls its
    configuration from the owning :class:`core.simulator.Simulator`;
    schedulers never see the engine.
    """

    def __init__(self, sim) -> None:
        self.sim = sim
        self.cluster = sim.cluster
        self.jobs: Dict[int, Job] = sim.jobs
        self.arrivals: List[Job] = sim.arrivals
        self.scheduler = sim.scheduler
        self.interference = sim.interference
        self.restart_penalty = sim.restart_penalty
        self.max_events = sim.max_events
        # restore co-tenants' sub-batches when a sharer departs (opt-in;
        # the paper's Algorithm 1 never retunes a running job)
        self.reconfig_on_release = sim.reconfig_on_release
        # fault injection: the timeline is precomputed by the Simulator
        # from the FaultModel seed alone; an empty timeline leaves the
        # event loop as it is with no fault model
        self.fault_model = sim.fault_model
        self._fault_heap: List[tuple] = list(sim.fault_events)
        heapq.heapify(self._fault_heap)

        self.time = 0.0
        self.pending: List[Job] = []
        self.running: Dict[int, Job] = {}
        self._arrival_idx = 0
        self._blocked_until: Dict[int, float] = {}
        self._events = 0
        self.log: List[tuple] = []
        self._heap: List[tuple] = []
        self._done_heap: List[tuple] = []
        self._entry_seq: Dict[int, int] = {}
        self._seq = 0
        self._dirty: set = set()
        self._pending_since: Dict[int, float] = {}

    # ------------------------------------------------------------------ #
    # Policy-facing mutations (invoked through the Simulator facade)
    # ------------------------------------------------------------------ #
    def start_job(self, job: Job, gpus: Sequence[int],
                  sub_batch: Optional[int] = None) -> None:
        if job.state == JobState.RUNNING:
            raise RuntimeError(f"job {job.jid} already running")
        gset = frozenset(gpus)
        if len(gset) != job.gpus:
            raise RuntimeError(
                f"job {job.jid} needs {job.gpus} GPUs, got {len(gset)}")
        self.cluster.allocate(job.jid, gset)
        job.placement = gset
        if sub_batch is not None:
            job.sub_batch = int(sub_batch)
            # ceil, not round: for b that does not divide B the final
            # micro-batch absorbs the remainder (s*b >= B), keeping the
            # effective batch — and convergence — unchanged.
            job.accum_steps = max(1, math.ceil(job.batch / job.sub_batch))
        job.state = JobState.RUNNING
        job.start_time = self.time
        if job.first_start_time is None:
            job.first_start_time = self.time
        job.last_progress_at = self.time
        # a job re-queued by a fault pays the restart penalty
        penalty = self.restart_penalty if job.preemptions > 0 else 0.0
        self._blocked_until[job.jid] = self.time + penalty
        self.running[job.jid] = job
        self._drop_pending(job)
        dirty = self._dirty
        occupancy = self.cluster.occupancy
        dirty.add(job.jid)
        for g in job.placement:
            dirty.update(occupancy[g])
        self.log.append((self.time, "start", job.jid, sorted(gset)))
        # the chosen (sub-batch, accumulation) configuration rides in a
        # separate entry so the 4-tuple "start" shape stays stable for
        # existing log consumers; replay (launch.cluster.plan_from_sim)
        # reads it to configure the physical job
        self.log.append((self.time, "config", job.jid,
                         int(job.sub_batch), int(job.accum_steps)))

    def reconfigure_job(self, job: Job, sub_batch: int) -> None:
        """Mid-run (τ, sub-batch) reconfiguration: the
        running job switches to ``sub_batch`` with ``s = ceil(B / b)``
        accumulation sub-steps — the effective batch is unchanged, only
        the iteration time (and hence the rate) moves. Progress is
        settled at the old rate first; the new rate takes effect from
        the current event time."""
        if job.state != JobState.RUNNING:
            raise RuntimeError(f"job {job.jid} not running")
        self._accrue(job, self.time)
        job.sub_batch = int(sub_batch)
        job.accum_steps = max(1, math.ceil(job.batch / job.sub_batch))
        self._dirty.add(job.jid)
        self._dirty.update(self.cluster.co_runners(job))
        self.log.append((self.time, "reconfig", job.jid,
                         int(job.sub_batch), int(job.accum_steps)))

    def _restore_tenants(self, gpus) -> None:
        """When a job departs, surviving co-tenants on its GPUs may fit a
        larger sub-batch again (fewer accumulation sub-steps — strictly
        faster, same effective batch). Gated by ``reconfig_on_release``."""
        from .batch_scaling import candidate_sub_batches
        cap = self.cluster.gpu_capacity_bytes
        seen = set()
        for g in gpus:
            for jid in self.cluster.occupancy[g]:
                if jid in seen:
                    continue
                seen.add(jid)
                tenant = self.jobs[jid]
                # binding constraint: the most-loaded of the tenant's
                # GPUs, each loaded by the SUM of its co-tenants (> 2
                # tenants per GPU is reachable via custom schedulers)
                other_mem = 0.0
                for gg in tenant.placement:
                    load = sum(
                        self.jobs[o].perf.mem_bytes(self.jobs[o].sub_batch)
                        for o in self.cluster.occupancy[gg] if o != jid)
                    other_mem = max(other_mem, load)
                for b in candidate_sub_batches(tenant.batch):
                    if tenant.perf.fits(b, cap, other_mem=other_mem):
                        if b != tenant.sub_batch:
                            self.reconfigure_job(tenant, b)
                        break

    # ------------------------------------------------------------------ #
    # Fault events (from the FaultModel's precomputed timeline)
    # ------------------------------------------------------------------ #
    def fail_job(self, job: Job) -> None:
        """An injected fault kills the running ``job``: its progress is
        settled, then **rounded down to the last checkpoint boundary**
        (``FaultModel.checkpoint_interval``; interval 0 restarts the
        attempt from scratch), the lost work accounted in
        ``job.lost_iters``, and the job re-queued — it pays the restart
        penalty on its next start. Surviving co-tenants of its GPUs are
        gracefully rescaled to the largest sub-batch that fits again
        (``FaultModel.rescale_peers``) via the reconfig machinery
        instead of being killed."""
        if job.state != JobState.RUNNING:
            raise RuntimeError(f"job {job.jid} not running")
        self._accrue(job, self.time)
        fm = self.fault_model
        kept = fm.truncate_progress(job.iters_done)
        job.lost_iters += job.iters_done - kept
        job.iters_done = kept
        job.failures += 1
        self._dirty.update(self.cluster.co_runners(job))
        self._dirty.discard(job.jid)
        self.cluster.release(job.jid, job.placement)
        released = job.placement
        job.placement = frozenset()
        job.state = JobState.PENDING
        job.preemptions += 1            # requeue invalidates sort keys
        job.current_rate = 0.0
        del self.running[job.jid]
        self._blocked_until.pop(job.jid, None)
        self.pending.append(job)
        self._entry_seq.pop(job.jid, None)
        self._pending_since[job.jid] = self.time
        self.log.append((self.time, "fail_job", job.jid))
        if fm.rescale_peers:
            self._restore_tenants(released)

    def fail_server(self, sid: int) -> None:
        """A server dies: every job holding one of its GPUs fails (in
        jid order, each via :meth:`fail_job`), then the server's GPUs
        leave the allocatable pool until the matching recover event. A
        server already down is left as it is."""
        cluster = self.cluster
        if sid in cluster.down_servers:
            return
        victims = sorted({jid for g in cluster.server_gpus(sid)
                          for jid in cluster.occupancy[g]})
        for jid in victims:
            self.fail_job(self.jobs[jid])
        cluster.set_server_down(sid)
        self.log.append((self.time, "fail_server", sid))

    def recover_server(self, sid: int) -> None:
        """A failed server returns; its GPUs rejoin the free pool (the
        scheduling pass that follows may place onto them immediately).
        Already-recovered servers no-op (correlated kill timelines can
        carry overlapping repair windows; the earliest recover wins)."""
        if sid not in self.cluster.down_servers:
            return
        self.cluster.set_server_up(sid)
        self.log.append((self.time, "recover_server", sid))

    def _process_faults(self, now: float) -> None:
        """Apply every fault event due at ``now``. Events targeting a
        job that is not running, or a server already in the target
        state, are consumed silently — the timeline is precomputed, the
        cluster state is not."""
        fh = self._fault_heap
        while fh and fh[0][0] <= now + _EPS:
            _t, _seq, kind, target = heapq.heappop(fh)
            if kind == "fail_job":
                job = self.jobs.get(target)
                if job is not None and job.state is JobState.RUNNING:
                    self.fail_job(job)
            elif kind == "fail_server":
                self.fail_server(target)
            elif kind == "recover_server":
                self.recover_server(target)
            else:   # pragma: no cover - timeline is engine-generated
                raise ValueError(f"unknown fault event kind {kind!r}")

    def _drop_pending(self, job: Job) -> None:
        pending = self.pending
        for i, p in enumerate(pending):
            if p is job:
                del pending[i]
                break
        since = self._pending_since.pop(job.jid, None)
        if since is not None:
            job.waiting_time += self.time - since

    # ------------------------------------------------------------------ #
    # Progress accounting
    # ------------------------------------------------------------------ #
    def effective_t_iter(self, job: Job) -> float:
        base = job.solo_t_iter
        occupancy = self.cluster.occupancy
        for g in job.placement:
            if len(occupancy[g]) > 1:
                break
        else:
            return base   # exclusive tenancy: no co-runner, xi = 1
        xi = 1.0
        for other_id in self.cluster.co_runners(job):
            other = self.jobs[other_id]
            mem = (job.perf.mem_bytes(job.sub_batch)
                   + other.perf.mem_bytes(other.sub_batch))
            xi = max(xi, self.interference.xi(
                job.model, other.model,
                t_me=base,
                t_other=other.solo_t_iter,
                mem_frac=mem / self.cluster.gpu_capacity_bytes))
        return base * xi

    def _accrue(self, job: Job, now: float) -> None:
        blocked_until = self._blocked_until.get(job.jid, 0.0)
        begin = max(job.last_progress_at, blocked_until)
        if now > begin and job.current_rate > 0:
            job.iters_done = min(
                job.iters, job.iters_done + (now - begin) * job.current_rate)
        if now > job.last_progress_at:
            # time stalled on a restart counts as queueing delay
            stalled = min(now, blocked_until) - job.last_progress_at
            if stalled > 0:
                job.waiting_time += stalled
        job.last_progress_at = now

    def remaining_at(self, job: Job) -> float:
        """``job``'s remaining iterations at the current event time,
        *without* materializing the accrual — the same float the next
        ``_accrue(job, self.time)`` would leave behind (identical
        IEEE-754 operation order). The sharing decision reads donors
        through this, so it needs no pre-pass accrual sweep."""
        b = self._blocked_until.get(job.jid, 0.0)
        lp = job.last_progress_at
        begin = lp if lp > b else b
        done = job.iters_done
        now = self.time
        rate = job.current_rate
        if now > begin and rate > 0.0:
            adv = done + (now - begin) * rate
            iters = job.iters
            done = adv if adv < iters else iters
        rem = job.iters - done
        return rem if rem > 0.0 else 0.0

    def _results(self) -> SimResults:
        makespan = max((j.finish_time for j in self.jobs.values()),
                       default=0.0)
        return SimResults(jobs=list(self.jobs.values()), makespan=makespan,
                          events=self._events, name=self.scheduler.name)

    # ------------------------------------------------------------------ #
    def _refresh_dirty(self) -> None:
        """Recompute rates and (re)index finish events for jobs whose
        co-runner sets changed since the last event. Updates are staged
        and applied in one batch: when the batch rivals the heap size
        (big placement waves), both heaps are rebuilt
        with a single ``heapify`` over the still-valid entries instead
        of O(batch x log heap) pushes — pop order only depends on the
        entry keys, so results are unchanged."""
        dirty = self._dirty
        if not dirty:
            return
        running = self.running
        blocked = self._blocked_until
        entry_seq = self._entry_seq
        now = self.time
        pushes: List[tuple] = []
        done_pushes: List[tuple] = []
        for jid in dirty:
            job = running.get(jid)
            if job is None:
                continue
            self._accrue(job, now)
            rate = 1.0 / self.effective_t_iter(job)
            job.current_rate = rate
            b = blocked.get(jid, 0.0)
            begin = now if now > b else b
            rem = job.iters - job.iters_done
            if rem < 0.0:
                rem = 0.0
            tol = _FINISH_TOL * (job.iters if job.iters > 1.0 else 1.0)
            self._seq = seq = self._seq + 1
            entry_seq[jid] = seq
            pushes.append((begin + rem / rate, seq, jid))
            done_pushes.append((begin + (rem - tol) / rate, seq, jid))
        dirty.clear()
        heap = self._heap
        if len(pushes) > 64 and 4 * len(pushes) >= len(heap):
            live = [e for e in heap if entry_seq.get(e[2]) == e[1]]
            live.extend(pushes)
            heapq.heapify(live)
            self._heap = live
            done = [e for e in self._done_heap
                    if entry_seq.get(e[2]) == e[1]]
            done.extend(done_pushes)
            heapq.heapify(done)
            self._done_heap = done
        else:
            heappush = heapq.heappush
            for e in pushes:
                heappush(heap, e)
            done = self._done_heap
            for e in done_pushes:
                heappush(done, e)

    # ------------------------------------------------------------------ #
    def run(self) -> SimResults:
        sim = self.sim
        scheduler = self.scheduler
        cluster = self.cluster
        running = self.running
        arrivals = self.arrivals
        pending = self.pending
        next_heap = self._heap
        done_heap = self._done_heap
        entry_seq = self._entry_seq
        pending_since = self._pending_since
        dirty = self._dirty
        accrue = self._accrue
        heappop = heapq.heappop
        inf = math.inf
        n_arrivals = len(arrivals)
        finished = 0
        total = len(self.jobs)
        scheduler.reset()

        while finished < total:
            self._events += 1
            if self._events > self.max_events:
                raise RuntimeError(
                    f"simulator exceeded {self.max_events} events "
                    f"({finished}/{total} finished at t={self.time:.1f}; "
                    f"pending={len(pending)})")

            # -- next event: valid heap top vs arrival vs fault -------
            while next_heap and entry_seq.get(next_heap[0][2]) != next_heap[0][1]:
                heappop(next_heap)
            t_next = next_heap[0][0] if next_heap else inf
            if self._arrival_idx < n_arrivals:
                t_arr = arrivals[self._arrival_idx].arrival
                if t_arr < t_next:
                    t_next = t_arr
            if self._fault_heap and self._fault_heap[0][0] < t_next:
                # pending fault/recover events are real future events
                # (a recover may be the only thing unblocking the queue)
                t_next = self._fault_heap[0][0]
            if t_next == inf:
                raise RuntimeError(
                    f"deadlock: {len(pending)} pending jobs, none "
                    f"running, no arrivals left (t={self.time:.1f})")
            if t_next < self.time - _EPS:
                raise RuntimeError("time went backwards")
            if t_next < self.time:
                t_next = self.time
            self.time = now = t_next

            # -- completions: jobs due per the tolerance ordering ------
            while done_heap:
                key, seq, jid = done_heap[0]
                if entry_seq.get(jid) != seq:
                    heappop(done_heap)
                    continue
                if key > now:
                    break
                heappop(done_heap)
                del entry_seq[jid]
                job = running[jid]
                accrue(job, now)
                job.iters_done = job.iters
                job.state = JobState.FINISHED
                job.finish_time = now
                for g in job.placement:
                    dirty.update(cluster.occupancy[g])
                dirty.discard(jid)
                released = job.placement
                cluster.release(jid, released)
                job.placement = frozenset()
                del running[jid]
                self._blocked_until.pop(jid, None)
                finished += 1
                self.log.append((now, "finish", jid))
                if self.reconfig_on_release:
                    self._restore_tenants(released)

            # -- faults ------------------------------------------------
            self._process_faults(now)

            # -- arrivals ----------------------------------------------
            idx = self._arrival_idx
            while idx < n_arrivals and arrivals[idx].arrival <= now + _EPS:
                job = arrivals[idx]
                pending.append(job)
                pending_since[job.jid] = now
                idx += 1
                self.log.append((now, "arrive", job.jid))
            self._arrival_idx = idx

            # -- schedule ----------------------------------------------
            scheduler.schedule(sim)

            # -- incremental rate refresh ------------------------------
            self._refresh_dirty()

        return self._results()

