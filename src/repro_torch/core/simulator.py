"""Policy-facing facade over the trace-driven discrete-event simulator
(Section VI), the port's copy of the reference's ``core/simulator.py``.
Jobs progress in continuous iterations; every event (arrival,
completion, scheduler tick, preemption, reconfiguration, fault)
re-derives the affected jobs' effective rate
1 / (t_iter * max xi over co-runners): gang scheduling means the slowest
(most-contended) GPU paces the whole job.

The event loop lives in :mod:`core.engine`: ``engine="heap"`` (the
default) is the indexed event-heap engine, ``engine="scan"`` the loop
that re-derives every event from all running jobs. ``decision`` picks
``SJF_BSBF``'s sharing-decision path: ``"scalar"`` (the default here:
the per-pair loop), ``"grid"`` or ``"batched"`` (numpy, the same
schedules). Both come as arguments only; no environment variable
chooses them. Schedulers only ever see this facade:
``pending``/``running``/``time``/``log`` and the
``start_job``/``preempt_job``/``reconfigure_job`` mutations proxy to the
engine.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .engine import SimResults, make_engine
from .faults import FaultModel
from .interference import InterferenceModel
from .job import ClusterState, Job

__all__ = ["DECISION_PATHS", "SchedulerBase", "SimResults", "Simulator"]

DECISION_PATHS = ("batched", "grid", "scalar")


def check_decision(decision: Optional[str]) -> None:
    """Refuses a decision path that does not exist, with the
    reference's message."""
    if decision is not None and decision not in DECISION_PATHS:
        raise ValueError(
            f"unknown decision path {decision!r}; "
            f"choose from {list(DECISION_PATHS)}")


class Simulator:
    def __init__(
        self,
        cluster: ClusterState,
        jobs: Sequence[Job],
        scheduler: "SchedulerBase",
        interference: Optional[InterferenceModel] = None,
        restart_penalty: float = 30.0,
        max_events: int = 2_000_000,
        engine: Optional[str] = None,
        decision: Optional[str] = None,
        reconfig_on_release: bool = False,
        fault_model: Optional[FaultModel] = None,
    ) -> None:
        self.cluster = cluster
        self.jobs: Dict[int, Job] = {j.jid: j for j in jobs}
        self.arrivals = sorted(jobs, key=lambda j: (j.arrival, j.jid))
        self.scheduler = scheduler
        self.interference = interference or InterferenceModel()
        self.restart_penalty = restart_penalty
        self.max_events = max_events
        # the fault timeline is precomputed here, from the model's seed
        # alone, so every engine and decision path replays the same fault
        # sequence; a job it kills pays ``restart_penalty`` on its restart
        self.fault_model = fault_model
        self.fault_events = (
            fault_model.timeline(cluster.n_servers, sorted(self.jobs))
            if fault_model is not None else [])
        # when a sharer departs, surviving co-tenants are restored to the
        # largest sub-batch that fits again (a mid-run reconfiguration,
        # logged as a "reconfig" event). Default off: the paper's
        # Algorithm 1 never retunes a running job.
        self.reconfig_on_release = reconfig_on_release
        self.engine_name = engine or "heap"
        # SJF_BSBF's sharing-decision path when the policy names none
        check_decision(decision)
        self.decision_path = decision or "scalar"
        self.engine = make_engine(self.engine_name, self)

    # ------------------------------------------------------------------ #
    # State proxied from the engine (read-side of the scheduler API)
    # ------------------------------------------------------------------ #
    @property
    def time(self) -> float:
        return self.engine.time

    @property
    def pending(self) -> List[Job]:
        return self.engine.pending

    @property
    def running(self) -> Dict[int, Job]:
        return self.engine.running

    @property
    def log(self) -> List[tuple]:
        return self.engine.log

    # ------------------------------------------------------------------ #
    # Scheduler-facing API
    # ------------------------------------------------------------------ #
    def start_job(self, job: Job, gpus: Sequence[int],
                  sub_batch: Optional[int] = None) -> None:
        self.engine.start_job(job, gpus, sub_batch=sub_batch)

    def preempt_job(self, job: Job) -> None:
        self.engine.preempt_job(job)

    def reconfigure_job(self, job: Job, sub_batch: int) -> None:
        self.engine.reconfigure_job(job, sub_batch)

    def fail_job(self, job: Job) -> None:
        """Inject a failure into a running job: its progress truncates to
        the last checkpoint, it re-queues, and surviving sharing peers
        are rescaled."""
        self.engine.fail_job(job)

    def fail_server(self, sid: int,
                    repair_after: Optional[float] = None) -> bool:
        return self.engine.fail_server(sid, repair_after=repair_after)

    def recover_server(self, sid: int) -> bool:
        return self.engine.recover_server(sid)

    def effective_t_iter(self, job: Job) -> float:
        return self.engine.effective_t_iter(job)

    def remaining_at(self, job: Job) -> float:
        """Remaining iterations of ``job`` at the current event time, a
        virtual read (no progress materialization); see
        :meth:`core.engine.EngineBase.remaining_at`."""
        return self.engine.remaining_at(job)

    def run(self) -> SimResults:
        return self.engine.run()


class SchedulerBase:
    """Interface; implementations in ``core.schedulers``."""

    name: str = "base"
    preemptive: bool = False
    tick_interval: Optional[float] = None
    tick_only: bool = False   # act only on ticks (interval schedulers)
    # Does schedule() read running jobs' progress (iters_done /
    # attained_service / remaining_iters)? Policies that only look at
    # static job fields and the pending queue set this False so the heap
    # engine skips the per-event accrual sweep.
    reads_running_progress: bool = True
    # Which running jobs the pre-schedule accrual must cover: "all"
    # (Tiresias/SRSF read every job's attained/remaining service) or
    # "donors" (Algorithm 1 only reads the remaining work of jobs owning
    # single-occupancy GPUs). Progress accrual is order-insensitive, so
    # narrowing the sweep leaves results unchanged.
    progress_scope: str = "all"

    def reset(self) -> None:
        """Called by the engine when a run starts. Stateful schedulers
        (incremental queues, per-job caches) clear per-run state here so
        one instance can drive several simulations."""

    def schedule(self, sim: Simulator) -> None:  # pragma: no cover
        raise NotImplementedError
