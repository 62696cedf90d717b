"""Schedule-driven multi-job executor (the reference's
``launch/cluster.py``): each sharing group advances every member one
(possibly gradient-accumulated) training step per call, time-multiplexed
on one device, and consumes a timeline of schedule events:

* ``start``    - a job joins with the sub-batch Algorithm 2 chose; its
                 accumulation count follows as ``s = ceil(B / b)``;
* ``reconfig`` - mid-run sub-batch change: the next group step
                 accumulates at the new sub-batch while the job's params
                 and optimizer state carry through untouched;
* ``finish``   - the member leaves.

PyTorch runs eagerly, so there is no compiled program to cache per group
composition and no warm-up on zero states: ``core.coschedule`` warms up
with one real step before it times. Walltimes bracket each group step
with ``torch.cuda.synchronize()``.

Fault injection, retry, checkpoints and ``plan_from_sim`` come in a later
slice.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.train import TrainConfig, adamw_init, make_train_step


@dataclass
class JobSpec:
    """One physical training job: architecture, per-step user batch and
    the gradient-accumulation split. Attention takes the flash kernels
    whenever the job's tensors are on the card."""

    cfg: ArchConfig
    batch: int                  # per-step user batch
    accum_steps: int = 1        # gradient-accumulation sub-steps
    seq: int = 128
    seed: int = 0

    def train_config(self) -> TrainConfig:
        return TrainConfig(accum_steps=self.accum_steps)


def _make_state(spec: JobSpec, device=None):
    dev = resolve_device(device)
    params = init_params(spec.cfg, spec.seed, device=dev)
    opt = adamw_init(params)
    batch = make_batch(spec.cfg, spec.batch, spec.seq, seed=spec.seed,
                       device=dev)
    return params, opt, batch


def accum_for_sub_batch(batch: int, sub_batch: int) -> int:
    """s = ceil(B / b); the final micro-batch absorbs the remainder
    (masked, so the effective batch is exactly B)."""
    if sub_batch < 1:
        raise ValueError(f"sub_batch must be >= 1, got {sub_batch}")
    return max(1, math.ceil(batch / min(sub_batch, batch)))


def make_group_step(specs: Sequence[JobSpec]):
    """One function stepping EVERY job in ``specs``, time-multiplexed:
    member i runs its full (possibly accumulated) train step, then member
    i+1. Flat signature, as the reference's:

        (p0, o0, b0, p1, o1, b1, ...) -> (p0, o0, m0, p1, o1, m1, ...)

    Params and optimizer state are updated in place."""
    steps = [make_train_step(s.cfg, s.train_config()) for s in specs]

    def group_step(*state):
        out: List[Any] = []
        for i, step in enumerate(steps):
            p, o, m = step(*state[3 * i:3 * i + 3])
            out += [p, o, m]
        return tuple(out)

    return group_step


@dataclass
class JobRun:
    """Live state of one job inside the executor."""

    name: str
    spec: JobSpec
    total_steps: int
    sub_batch: int = 0
    accum_steps: int = 1
    params: Any = field(default=None, repr=False)
    opt: Any = field(default=None, repr=False)
    batch: Any = field(default=None, repr=False)
    steps_done: int = 0
    walltime: float = 0.0       # attributed execution seconds
    started: bool = False
    finished: bool = False
    reconfigs: List[Tuple[int, int]] = field(default_factory=list)
    last_metrics: Any = field(default=None, repr=False)

    def report(self) -> Dict[str, Any]:
        out = {
            "steps": self.steps_done,
            "walltime": self.walltime,
            "sub_batch": self.sub_batch,
            "accum_steps": self.accum_steps,
            "reconfigs": list(self.reconfigs),
        }
        if self.last_metrics is not None:
            out["loss"] = float(self.last_metrics["loss"])
        return out


@dataclass(frozen=True)
class PlanOp:
    """Schedule event applied at a phase boundary."""

    kind: str                       # "start" | "reconfig" | "finish"
    job: str
    sub_batch: Optional[int] = None


@dataclass(frozen=True)
class PlanPhase:
    """Interval between two schedule events: ``ops`` fire at entry, then
    every sharing group advances its members' step ``quotas``
    round-robin. A group's walltime is attributed to all its running
    members."""

    ops: Tuple[PlanOp, ...]
    quotas: Tuple[Tuple[str, int], ...]
    groups: Tuple[Tuple[str, ...], ...]


class ScheduleExecutor:
    """Executes a schedule of N-way shared training groups on one device
    (``cuda`` unless ``device="cpu"`` is passed)."""

    def __init__(self, *, device=None) -> None:
        self.device = resolve_device(device)
        self.runs: Dict[str, JobRun] = {}

    def submit(self, name: str, spec: JobSpec, steps: int) -> JobRun:
        if name in self.runs:
            raise ValueError(f"job {name!r} already submitted")
        run = JobRun(name=name, spec=spec, total_steps=int(steps),
                     sub_batch=spec.batch, accum_steps=spec.accum_steps)
        self.runs[name] = run
        return run

    def start(self, name: str, *, sub_batch: Optional[int] = None,
              state: Optional[tuple] = None) -> JobRun:
        """Materialize the job's params/opt/batch (or take a prebuilt
        ``state`` triple, used as it is, not copied) and optionally apply
        the sub-batch Algorithm 2 chose."""
        run = self.runs[name]
        if run.started:
            raise RuntimeError(f"job {name!r} already started")
        if sub_batch is not None:
            run.sub_batch = int(sub_batch)
            run.accum_steps = accum_for_sub_batch(run.spec.batch,
                                                  run.sub_batch)
        run.params, run.opt, run.batch = (
            state if state is not None
            else _make_state(run.spec, self.device))
        run.started = True
        return run

    def reconfigure(self, name: str, sub_batch: int) -> JobRun:
        """Mid-run sub-batch change: params/opt state carry through
        untouched and the effective batch is unchanged."""
        run = self.runs[name]
        if not run.started or run.finished:
            raise RuntimeError(f"job {name!r} not running")
        run.sub_batch = int(sub_batch)
        run.accum_steps = accum_for_sub_batch(run.spec.batch, run.sub_batch)
        run.reconfigs.append((run.steps_done, run.sub_batch))
        return run

    def finish(self, name: str) -> JobRun:
        """The job leaves. Its params, optimizer state and batch are
        released so a co-tenant or successor can use the device memory;
        the report keeps its metrics."""
        run = self.runs[name]
        if run.steps_done != run.total_steps:
            raise RuntimeError(
                f"job {name!r} finished at {run.steps_done}/"
                f"{run.total_steps} steps")
        run.finished = True
        run.params = run.opt = run.batch = None
        return run

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step_group(self, names: Sequence[str]) -> Dict[str, Any]:
        """One group call advancing every named job one step. Returns the
        call's walltime and per-job losses."""
        runs = [self.runs[n] for n in names]
        for r in runs:
            if not r.started or r.finished:
                raise RuntimeError(f"job {r.name!r} not running")
        prog = make_group_step(
            [dataclasses.replace(r.spec, accum_steps=r.accum_steps)
             for r in runs])
        args: List[Any] = []
        for r in runs:
            args += [r.params, r.opt, r.batch]
        self._sync()
        t0 = time.perf_counter()
        out = prog(*args)
        self._sync()
        dt = time.perf_counter() - t0
        losses = {}
        for i, r in enumerate(runs):
            r.params, r.opt, r.last_metrics = out[3 * i:3 * i + 3]
            r.steps_done += 1
            losses[r.name] = float(r.last_metrics["loss"])
        return {"walltime": dt, "losses": losses}

    def _apply(self, op: PlanOp) -> None:
        if op.kind == "start":
            self.start(op.job, sub_batch=op.sub_batch)
        elif op.kind == "reconfig":
            self.reconfigure(op.job, op.sub_batch)
        elif op.kind == "finish":
            self.finish(op.job)
        else:
            raise ValueError(f"unknown plan op {op.kind!r}")

    def execute(self, phases: Sequence[PlanPhase]
                ) -> Dict[str, Dict[str, Any]]:
        """Run schedule phases to completion; returns the per-job report
        (each group phase's walltime attributed to every running
        member)."""
        for phase in phases:
            for op in phase.ops:
                self._apply(op)
            quotas = dict(phase.quotas)
            for group in phase.groups:
                left = {n: quotas.get(n, 0) for n in group
                        if quotas.get(n, 0) > 0}
                t_group = 0.0
                while left:
                    members = sorted(left)
                    t_group += self.step_group(members)["walltime"]
                    for n in members:
                        left[n] -= 1
                        if left[n] == 0:
                            del left[n]
                for n in group:
                    run = self.runs[n]
                    if run.started and not run.finished:
                        run.walltime += t_group
        return {name: run.report() for name, run in self.runs.items()}
