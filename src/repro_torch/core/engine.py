"""The discrete-event engines behind :class:`core.simulator.Simulator`,
the port's copy of the reference's ``core/engine.py`` with the same
arithmetic in the same order. Both engines give the same observable
schedule:

* :class:`HeapEngine` (the default): an indexed binary heap of predicted
  finish events with lazy invalidation (per-job sequence numbers; stale
  entries are discarded on pop), a *dirty set* of jobs whose GPU
  co-runner sets changed (from ``start_job`` / ``preempt_job`` /
  ``reconfigure_job`` / a fault / release-on-finish) so interference
  rates are only recomputed for those, and lazy progress/waiting
  accrual, so an event costs O(log running + |dirty|).
* :class:`ScanEngine`: every event re-derives the next event time with
  a ``min()`` over all running jobs and refreshes every running job's
  rate. O(running x co-runners) per event; the yardstick the heap
  engine is held to (within rel 1e-6: it accrues every job at every
  event, so its clock differs in the last bits).

Both own the event clock, the pending/running queues, scheduler ticks
and the progress accounting; the policy-facing
:class:`core.simulator.Simulator` proxies to the active engine.
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

    def jct_list(self) -> List[float]:
        return sorted(j.jct() for j in self.jobs)

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


class EngineBase:
    """Event clock, queues, and progress accounting shared by both engines.

    The constructor pulls its configuration from the owning
    :class:`core.simulator.Simulator`; schedulers never see the engine:
    they interact with the facade, which proxies to it.
    """

    name = "base"

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
        # fault injection. The timeline is precomputed by the Simulator
        # from the FaultModel seed alone, so every engine
        # and decision path replays the identical fault sequence; an
        # empty timeline leaves the event loop bit-identical to a run
        # with no fault model. Dynamic events (a chaos scheduler's
        # fail_server with a repair time) push into the same heap.
        self.fault_model = sim.fault_model
        self._fault_heap: List[tuple] = list(sim.fault_events)
        heapq.heapify(self._fault_heap)
        self._fault_seq = len(self._fault_heap)

        self.time = 0.0
        self.pending: List[Job] = []
        self.running: Dict[int, Job] = {}
        # monotone preemption counter: the vectorized pending table
        # (core.pass_batch) rebuilds when it moves, because a
        # requeued job re-enters the queue with a changed sort key
        self.preemptions_total = 0
        # monotone reconfiguration counter: the batched decision path's
        # donor cache keys on it beside the occupancy version, since a
        # reconfiguration changes a donor's sub-batch, memory and
        # iteration time without a placement
        self.reconfigs_total = 0
        self._arrival_idx = 0
        self._blocked_until: Dict[int, float] = {}
        self._next_tick = (self.scheduler.tick_interval
                           if self.scheduler.tick_interval else None)
        self._events = 0
        self.log: List[tuple] = []

    # ------------------------------------------------------------------ #
    # Policy-facing mutations (invoked through the Simulator facade)
    # ------------------------------------------------------------------ #
    def start_job(self, job: Job, gpus: Sequence[int],
                  sub_batch: Optional[int] = None) -> None:
        if job.state == JobState.RUNNING:
            raise RuntimeError(f"job {job.jid} already running")
        gset = frozenset(gpus)
        want = job.alloc_gpus or job.gpus
        if len(gset) != want:
            raise RuntimeError(
                f"job {job.jid} needs {want} GPUs, got {len(gset)}")
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
        penalty = self.restart_penalty if job.preemptions > 0 else 0.0
        self._blocked_until[job.jid] = self.time + penalty
        self.running[job.jid] = job
        fl = self.cluster._flat
        if fl is not None:
            fl.note_start(job, self._blocked_until[job.jid])
        self._drop_pending(job)
        self._on_start(job)
        self.log.append((self.time, "start", job.jid, sorted(gset)))
        # the chosen (sub-batch, accumulation) configuration rides in a
        # separate entry so the 4-tuple "start" shape stays stable for
        # existing log consumers; replay (launch.cluster.plan_from_sim)
        # reads it to configure the physical job
        self.log.append((self.time, "config", job.jid,
                         int(job.sub_batch), int(job.accum_steps)))

    def preempt_job(self, job: Job) -> None:
        if job.state != JobState.RUNNING:
            raise RuntimeError(f"job {job.jid} not running")
        self._accrue(job, self.time)
        self._on_preempt(job)
        self.cluster.release(job.jid, job.placement)
        job.placement = frozenset()
        job.state = JobState.PENDING
        job.preemptions += 1
        job.current_rate = 0.0
        self.preemptions_total += 1
        fl = self.cluster._flat
        if fl is not None:
            fl.note_rate(job)
        del self.running[job.jid]
        self._blocked_until.pop(job.jid, None)
        self.pending.append(job)
        self._on_requeued(job)
        self.log.append((self.time, "preempt", job.jid))

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
        self.reconfigs_total += 1
        fl = self.cluster._flat
        if fl is not None:
            fl.note_reconfig(job)
        self._on_reconfig(job)
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
        (``FaultModel.checkpoint_interval``; no fault model / interval 0
        restarts the attempt from scratch), the lost work accounted in
        ``job.lost_iters``, and the job re-queued — it pays the restart
        penalty on its next start like a preempted job. Surviving
        co-tenants of its GPUs are gracefully rescaled to the largest
        sub-batch that fits again (``FaultModel.rescale_peers``) via the
        reconfig machinery instead of being killed."""
        if job.state != JobState.RUNNING:
            raise RuntimeError(f"job {job.jid} not running")
        self._accrue(job, self.time)
        fm = self.fault_model
        kept = fm.truncate_progress(job.iters_done) if fm is not None \
            else 0.0
        job.lost_iters += job.iters_done - kept
        job.iters_done = kept
        job.failures += 1
        self._on_preempt(job)
        self.cluster.release(job.jid, job.placement)
        released = job.placement
        job.placement = frozenset()
        job.state = JobState.PENDING
        job.preemptions += 1            # requeue invalidates sort keys
        job.current_rate = 0.0
        self.preemptions_total += 1
        fl = self.cluster._flat
        if fl is not None:
            fl.note_rate(job)
            fl.note_progress(job)
        del self.running[job.jid]
        self._blocked_until.pop(job.jid, None)
        self.pending.append(job)
        self._on_requeued(job)
        self.log.append((self.time, "fail_job", job.jid))
        if fm is None or fm.rescale_peers:
            self._restore_tenants(released)

    def fail_server(self, sid: int,
                    repair_after: Optional[float] = None) -> bool:
        """A server dies: every job holding one of its GPUs fails (in
        jid order, each via :meth:`fail_job`), then the server's GPUs
        leave the allocatable pool until the matching recover event.
        ``repair_after`` schedules that recovery onto the fault heap —
        callers injecting failures dynamically (the chaos harness) use
        it so the event loop knows capacity is coming back and does not
        mistake the lull for a deadlock. Returns False (and does
        nothing) if the server is already down."""
        cluster = self.cluster
        if sid < 0 or sid >= cluster.n_servers:
            raise ValueError(f"no server {sid}")
        if sid in cluster.down_servers:
            return False
        victims = sorted({jid for g in cluster.server_gpus(sid)
                          for jid in cluster.occupancy[g]})
        for jid in victims:
            self.fail_job(self.jobs[jid])
        cluster.set_server_down(sid)
        self.log.append((self.time, "fail_server", sid))
        if repair_after is not None:
            self._fault_seq = seq = self._fault_seq + 1
            heapq.heappush(self._fault_heap,
                           (self.time + repair_after, seq,
                            "recover_server", sid))
        return True

    def recover_server(self, sid: int) -> bool:
        """A failed server returns; its GPUs rejoin the free pool (the
        scheduling pass that follows may place onto them immediately).
        Already-recovered servers no-op (correlated kill timelines can
        carry overlapping repair windows; the earliest recover wins)."""
        if sid not in self.cluster.down_servers:
            return False
        self.cluster.set_server_up(sid)
        self.log.append((self.time, "recover_server", sid))
        return True

    def _next_fault_time(self) -> float:
        return self._fault_heap[0][0] if self._fault_heap else math.inf

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

    # Engine-specific bookkeeping hooks -------------------------------- #
    def _drop_pending(self, job: Job) -> None:
        if job in self.pending:
            self.pending.remove(job)

    def _on_start(self, job: Job) -> None:
        pass

    def _on_preempt(self, job: Job) -> None:
        """Called while ``job`` still holds its GPUs (before release)."""

    def _on_requeued(self, job: Job) -> None:
        pass

    def _on_reconfig(self, job: Job) -> None:
        """Called after a running job's sub-batch changed (its own and
        its co-runners' rates need a refresh)."""

    # ------------------------------------------------------------------ #
    # Progress accounting
    # ------------------------------------------------------------------ #
    def effective_t_iter(self, job: Job) -> float:
        base = job.base_t_iter()
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
            job.attained_service += job.gpus * (now - job.last_progress_at)
            # time stalled on restart/migration counts as queueing delay
            stalled = min(now, blocked_until) - job.last_progress_at
            if stalled > 0:
                job.waiting_time += stalled
        job.last_progress_at = now
        fl = self.cluster._flat
        if fl is not None:
            fl.note_progress(job)

    def _predicted_finish(self, job: Job) -> float:
        if job.current_rate <= 0:
            return math.inf
        begin = max(self.time, self._blocked_until.get(job.jid, 0.0))
        return begin + job.remaining_iters / job.current_rate

    def remaining_at(self, job: Job) -> float:
        """``job``'s remaining iterations at the current event time,
        *without* materializing the accrual — the same float the next
        ``_accrue(job, self.time)`` would leave behind (identical
        IEEE-754 operation order). All sharing-decision paths read
        donors through this (or its vectorized mirror,
        ``pass_batch.FlatJobs.donor_rem``), so scalar, batched, and
        grid decisions see bit-identical donor state with no
        O(donors) pre-pass accrual sweep."""
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

    def run(self) -> SimResults:  # pragma: no cover - abstract
        raise NotImplementedError


# ---------------------------------------------------------------------- #
class ScanEngine(EngineBase):
    """The scan event loop: every event re-derives the next event time
    with a ``min()`` over all running jobs and refreshes every running
    job's rate. O(running x co-runners) per event."""

    name = "scan"

    def effective_t_iter(self, job: Job) -> float:
        # no solo_t_iter memo on the co-runner lookup, as the
        # reference's scan engine; the t_other pricing follows the
        # final-microbatch-aware Eq. 7 (t_iter_sub) so both engines see
        # the same structural xi for non-divisor sub-batches
        base = job.base_t_iter()
        xi = 1.0
        for other_id in self.cluster.co_runners(job):
            other = self.jobs[other_id]
            mem = (job.perf.mem_bytes(job.sub_batch)
                   + other.perf.mem_bytes(other.sub_batch))
            xi = max(xi, self.interference.xi(
                job.model, other.model,
                t_me=base,
                t_other=other.perf.t_iter_sub(other.batch, other.sub_batch),
                mem_frac=mem / self.cluster.gpu_capacity_bytes))
        return base * xi

    def _refresh_rates(self) -> None:
        fl = self.cluster._flat
        for job in self.running.values():
            job.current_rate = 1.0 / self.effective_t_iter(job)
            if fl is not None:
                fl.note_rate(job)

    def run(self) -> SimResults:
        finished = 0
        total = len(self.jobs)
        self.scheduler.reset()
        self._refresh_rates()
        while finished < total:
            self._events += 1
            if self._events > self.max_events:
                raise RuntimeError(
                    f"simulator exceeded {self.max_events} events "
                    f"({finished}/{total} finished at t={self.time:.1f}; "
                    f"pending={len(self.pending)})")
            # -- next event time ---------------------------------------
            candidates: List[float] = []
            if self._arrival_idx < len(self.arrivals):
                candidates.append(self.arrivals[self._arrival_idx].arrival)
            for job in self.running.values():
                candidates.append(self._predicted_finish(job))
            if self._next_tick is not None:
                candidates.append(self._next_tick)
            if self._fault_heap:
                # A pending recover event is a real future event: jobs
                # may be stuck pending purely because servers are down.
                candidates.append(self._fault_heap[0][0])
            if not candidates:
                raise RuntimeError(
                    f"deadlock: {len(self.pending)} pending jobs, none "
                    f"running, no arrivals left (t={self.time:.1f})")
            t_next = min(candidates)
            if t_next < self.time - _EPS:
                raise RuntimeError("time went backwards")
            t_next = max(t_next, self.time)

            # -- advance all running jobs to t_next --------------------
            for job in list(self.running.values()):
                self._accrue(job, t_next)
            for job in self.pending:
                job.waiting_time += t_next - self.time
            self.time = t_next

            # -- completions -------------------------------------------
            for job in list(self.running.values()):
                if job.remaining_iters <= _FINISH_TOL * max(1.0, job.iters):
                    job.iters_done = job.iters
                    job.state = JobState.FINISHED
                    job.finish_time = self.time
                    released = job.placement
                    self.cluster.release(job.jid, released)
                    job.placement = frozenset()
                    del self.running[job.jid]
                    self._blocked_until.pop(job.jid, None)
                    finished += 1
                    self.log.append((self.time, "finish", job.jid))
                    if self.reconfig_on_release:
                        self._restore_tenants(released)

            # -- faults ------------------------------------------------
            self._process_faults(self.time)

            # -- arrivals ----------------------------------------------
            while (self._arrival_idx < len(self.arrivals)
                   and self.arrivals[self._arrival_idx].arrival
                       <= self.time + _EPS):
                job = self.arrivals[self._arrival_idx]
                self.pending.append(job)
                self._arrival_idx += 1
                self.log.append((self.time, "arrive", job.jid))

            # -- tick bookkeeping --------------------------------------
            tick_crossed = False
            if (self._next_tick is not None
                    and self.time + _EPS >= self._next_tick):
                self._next_tick = self.time + self.scheduler.tick_interval
                tick_crossed = True

            # -- schedule ----------------------------------------------
            if not self.scheduler.tick_only or tick_crossed:
                self.scheduler.schedule(self.sim)
            self._refresh_rates()

        return self._results()


# ---------------------------------------------------------------------- #
class HeapEngine(EngineBase):
    """Indexed event-heap engine (the default).

    Two heaps share one set of live entries, validated by per-job
    sequence numbers (``_entry_seq``):

    * ``_heap``      — keyed by the predicted finish time; drives the
                       next-event clock together with the next arrival
                       and the next scheduler tick.
    * ``_done_heap`` — keyed by the time at which the job's remaining
                       work drops inside the finish tolerance; replays
                       the scan engine's "complete at the first event
                       where remaining <= tol" semantics without the
                       per-event sweep.

    Rates are recomputed only for the dirty set — jobs whose co-runner
    sets changed via start/preempt/finish — and progress is accrued
    lazily: at rate changes, completion, preemption, and (for policies
    that declare ``reads_running_progress``) right before scheduling.
    """

    name = "heap"

    def __init__(self, sim) -> None:
        super().__init__(sim)
        self._heap: List[tuple] = []
        self._done_heap: List[tuple] = []
        self._entry_seq: Dict[int, int] = {}
        self._seq = 0
        self._dirty: set = set()
        self._pending_since: Dict[int, float] = {}

    # -- bookkeeping hooks --------------------------------------------- #
    def _drop_pending(self, job: Job) -> None:
        pending = self.pending
        for i, p in enumerate(pending):
            if p is job:
                del pending[i]
                break
        since = self._pending_since.pop(job.jid, None)
        if since is not None:
            job.waiting_time += self.time - since

    def _on_start(self, job: Job) -> None:
        dirty = self._dirty
        occupancy = self.cluster.occupancy
        dirty.add(job.jid)
        for g in job.placement:
            dirty.update(occupancy[g])

    def _on_preempt(self, job: Job) -> None:
        self._dirty.update(self.cluster.co_runners(job))
        self._dirty.discard(job.jid)

    def _on_requeued(self, job: Job) -> None:
        self._entry_seq.pop(job.jid, None)
        self._pending_since[job.jid] = self.time

    def _on_reconfig(self, job: Job) -> None:
        self._dirty.add(job.jid)
        self._dirty.update(self.cluster.co_runners(job))

    # ------------------------------------------------------------------ #
    def _refresh_dirty(self) -> None:
        """Recompute rates and (re)index finish events for jobs whose
        co-runner sets changed since the last event. Updates are staged
        and applied in one batch: when the batch rivals the heap size
        (mass preemption, big placement waves), both heaps are rebuilt
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
        fl = self.cluster._flat
        pushes: List[tuple] = []
        done_pushes: List[tuple] = []
        for jid in dirty:
            job = running.get(jid)
            if job is None:
                continue
            self._accrue(job, now)
            rate = 1.0 / self.effective_t_iter(job)
            job.current_rate = rate
            if fl is not None:
                fl.note_rate(job)
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
        tick_only = scheduler.tick_only
        reads_progress = scheduler.reads_running_progress
        donors_only = scheduler.progress_scope == "donors"
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

            # -- next event: valid heap top vs arrival vs tick ---------
            while next_heap and entry_seq.get(next_heap[0][2]) != next_heap[0][1]:
                heappop(next_heap)
            t_next = next_heap[0][0] if next_heap else inf
            if self._arrival_idx < n_arrivals:
                t_arr = arrivals[self._arrival_idx].arrival
                if t_arr < t_next:
                    t_next = t_arr
            if self._next_tick is not None and self._next_tick < t_next:
                t_next = self._next_tick
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

            # -- tick bookkeeping --------------------------------------
            tick_crossed = False
            if self._next_tick is not None and now + _EPS >= self._next_tick:
                self._next_tick = now + scheduler.tick_interval
                tick_crossed = True

            # -- schedule ----------------------------------------------
            if not tick_only or tick_crossed:
                if reads_progress:
                    if donors_only:
                        # Algorithm 1 only reads donors' remaining work;
                        # everyone else keeps accruing lazily at rate
                        # changes / completion (order-insensitive).
                        for jid in cluster.donor_jids():
                            accrue(running[jid], now)
                    else:
                        for job in running.values():
                            accrue(job, now)
                scheduler.schedule(sim)

            # -- incremental rate refresh ------------------------------
            self._refresh_dirty()

        return self._results()


ENGINES = {
    "scan": ScanEngine,
    "heap": HeapEngine,
}


def make_engine(name: str, sim) -> EngineBase:
    try:
        cls = ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown simulator engine {name!r}; "
                         f"choose from {sorted(ENGINES)}") from None
    return cls(sim)
