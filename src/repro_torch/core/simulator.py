"""Policy-facing facade over the trace-driven discrete-event simulator
(Section VI), the port's copy of the reference's ``core/simulator.py``
with its heap engine and its scalar decision path, for the port's one
policy, the non-preemptive, tick-free ``SJF_BSBF``. Jobs progress in
continuous iterations; every event (arrival, completion,
reconfiguration, fault) re-derives the affected jobs' effective rate
1 / (t_iter * max xi over co-runners): gang scheduling means the slowest
(most-contended) GPU paces the whole job. Schedulers only ever see this
facade: ``pending``/``running``/``time``/``log`` and the
``start_job``/``reconfigure_job`` mutations proxy to the engine
(:mod:`core.engine`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .engine import HeapEngine, SimResults
from .faults import FaultModel
from .interference import InterferenceModel
from .job import ClusterState, Job

__all__ = ["SchedulerBase", "SimResults", "Simulator"]


class Simulator:
    def __init__(
        self,
        cluster: ClusterState,
        jobs: Sequence[Job],
        scheduler: "SchedulerBase",
        interference: Optional[InterferenceModel] = None,
        restart_penalty: float = 30.0,
        max_events: int = 2_000_000,
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
        # alone; a job it kills pays ``restart_penalty`` on its restart
        self.fault_model = fault_model
        self.fault_events = (
            fault_model.timeline(cluster.n_servers, sorted(self.jobs))
            if fault_model is not None else [])
        # when a sharer departs, surviving co-tenants are restored to the
        # largest sub-batch that fits again (a mid-run reconfiguration,
        # logged as a "reconfig" event). Default off: the paper's
        # Algorithm 1 never retunes a running job.
        self.reconfig_on_release = reconfig_on_release
        self.engine = HeapEngine(self)

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

    def reconfigure_job(self, job: Job, sub_batch: int) -> None:
        self.engine.reconfigure_job(job, sub_batch)

    def effective_t_iter(self, job: Job) -> float:
        return self.engine.effective_t_iter(job)

    def remaining_at(self, job: Job) -> float:
        """Remaining iterations of ``job`` at the current event time, a
        virtual read (no progress materialization); see
        :meth:`core.engine.HeapEngine.remaining_at`."""
        return self.engine.remaining_at(job)

    def run(self) -> SimResults:
        return self.engine.run()


class SchedulerBase:
    """Interface; the port's policy is ``core.schedulers.SJF_BSBF``. The
    engine calls :meth:`schedule` after every event and accrues no
    progress before it: a policy reads running jobs' remaining work
    through ``Simulator.remaining_at``."""

    name: str = "base"

    def reset(self) -> None:
        """Called by the engine when a run starts. Stateful schedulers
        clear per-run state here so one instance can drive several
        simulations."""

    def schedule(self, sim: Simulator) -> None:  # pragma: no cover
        raise NotImplementedError
