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

Fault tolerance, as in the reference: a scripted fault injector is
consulted before every group call; a transient fault is retried with
bounded backoff (``util.retry``), a fatal fault or an exhausted retry
drops the member while the survivors keep stepping; periodic checkpoints
(``checkpoint.npz``) are snapshotted to the host synchronously and
written by a background thread; :meth:`ScheduleExecutor.restart` resumes
a failed job from its last checkpoint bit-exactly.

PyTorch runs eagerly, so there is no compiled program to cache per group
composition and no warm-up on zero states: ``core.coschedule`` warms up
with one real step before it times. Walltimes bracket each group step
with ``torch.cuda.synchronize()``.

:func:`plan_from_sim` closes the loop with the simulator: it replays a
``core.simulator.Simulator`` event log into a :class:`SchedulePlan`
(phases between schedule events, each with per-job step quotas derived
from the simulated rates, and the sharing groups as connected components
of GPU co-tenancy), which :meth:`ScheduleExecutor.execute` runs,
reporting measured per-job execution seconds beside the simulator's
prediction (``launch.replay``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import checkpoint as _ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.data import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.train import (OptState, TrainConfig, adamw_init,
                               make_train_step)
from repro_torch.tree import tree_map
from repro_torch.util.retry import RetryPolicy, retry_call
from repro_torch.util.spans import install_gc_spans, span


# ---------------------------------------------------------------------- #
# Fault injection
# ---------------------------------------------------------------------- #
class TransientFault(RuntimeError):
    """A recoverable step failure (an ECC blip, a flaky interconnect):
    the executor retries the group call with backoff. Raised by fault
    injectors *before* the call: the step updates params and moments in
    place, so only a call that has not started can be replayed."""

    def __init__(self, job: str, msg: str = "") -> None:
        self.job = job
        super().__init__(msg or f"transient fault on job {job!r}")


class FatalFault(RuntimeError):
    """An unrecoverable member failure (an OOM-killed worker, a dead
    host): not retried. The member drops from its group, the survivors
    keep stepping, and the job restarts later from its last
    checkpoint."""

    def __init__(self, job: str, msg: str = "") -> None:
        self.job = job
        super().__init__(msg or f"fatal fault on job {job!r}")


@dataclass
class FaultSpec:
    """One scripted fault: fires when the executor's group-call counter
    reaches ``call`` and ``job`` is a member of that call. ``times`` is
    the number of consecutive attempts it poisons: a transient spec with
    ``times < retry attempts`` is survived by the retry loop, one with
    ``times >= attempts`` exhausts it (and escalates to a drop)."""

    call: int
    job: str
    kind: str = "transient"     # "transient" | "fatal"
    times: int = 1

    def __post_init__(self) -> None:
        if self.kind not in ("transient", "fatal"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class ScriptedFaults:
    """Deterministic fault injector: a list of :class:`FaultSpec`
    consulted before every group call (and by the decode engine before
    every segment, as job ``"segment"``). The same script replays the
    same failure sequence bit-exactly."""

    def __init__(self, specs: Sequence[FaultSpec]) -> None:
        self._remaining = [(s, [s.times]) for s in specs]

    def check(self, call: int, names: Sequence[str]) -> None:
        for spec, rem in self._remaining:
            if spec.call == call and spec.job in names and rem[0] > 0:
                rem[0] -= 1
                if spec.kind == "fatal":
                    raise FatalFault(spec.job)
                raise TransientFault(spec.job)


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
    failed: bool = False        # dropped by a fault; restart() clears
    restarts: int = 0
    retries: int = 0            # transient faults absorbed by backoff
    last_ckpt_step: int = -1    # steps_done at the last checkpoint
    reconfigs: List[Tuple[int, int]] = field(default_factory=list)
    last_metrics: Any = field(default=None, repr=False)

    def report(self) -> Dict[str, Any]:
        out = {
            "steps": self.steps_done,
            "walltime": self.walltime,
            "sub_batch": self.sub_batch,
            "accum_steps": self.accum_steps,
            "reconfigs": list(self.reconfigs),
            "failed": self.failed,
            "restarts": self.restarts,
            "retries": self.retries,
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
    members: a time-multiplexed tenant pays for its co-tenants' rounds
    as it would on a shared GPU."""

    ops: Tuple[PlanOp, ...]
    quotas: Tuple[Tuple[str, int], ...]
    groups: Tuple[Tuple[str, ...], ...]
    sim_duration: float = 0.0       # predicted interval length (seconds)


@dataclass
class SchedulePlan:
    phases: List[PlanPhase]
    predicted: Dict[str, Dict[str, float]]   # name -> {exec_seconds, jct}


class ScheduleExecutor:
    """Executes a schedule of N-way shared training groups on one device
    (``cuda`` unless ``device="cpu"`` is passed).

    Fault tolerance: ``fault_injector`` is consulted before every group
    call; transient faults retry under ``retry_policy`` (jitter from
    ``retry_seed``, waits through ``sleep``); a fatal fault or an
    exhausted retry marks the member ``failed`` and drops it. With
    ``checkpoint_dir``, every ``checkpoint_every`` steps a job's state is
    written to ``<dir>/<name><checkpoint_tag>.npz``. At most
    ``CKPT_SNAPSHOTS`` host snapshots (params, moments and step) exist at
    once, one being written and the rest queued: a checkpoint beyond them
    waits for the writer, so host memory stays under two copies of the
    largest job's state however short ``checkpoint_every`` is.

    ``rules`` (a ``sharding.rules.ShardingRules``) runs every job on
    DTensors over ``rules.mesh``, as the reference traces its programs
    under the rules: parameters and moments at their sanitized placements
    (``launch.specs.param_shardings``), the batch over the batch axes,
    each group call inside the activation rules; a checkpoint gathers the
    whole tensors, and a restore distributes them again. The reference's
    ``donate`` and ``program_cache`` are left out: the port updates state
    in place, runs eagerly and compiles no program."""

    CKPT_SNAPSHOTS = 2

    def __init__(self, *, device=None, rules=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 checkpoint_tag: str = "",
                 fault_injector: Optional[ScriptedFaults] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 retry_seed: int = 0,
                 sleep=time.sleep) -> None:
        self.device = resolve_device(device)
        self.rules = rules
        self.runs: Dict[str, JobRun] = {}
        self.calls = 0
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        # lands between the job name and ".npz" (``job.e0003.npz``)
        self.checkpoint_tag = checkpoint_tag
        self.fault_injector = fault_injector
        self.retry_policy = retry_policy or RetryPolicy()
        self._retry_rng = random.Random(retry_seed)
        self._sleep = sleep
        self.retries_total = 0
        self.drops_total = 0
        self.checkpoints_written = 0
        # (host snapshot s, background write s) of each written checkpoint
        self.checkpoint_seconds: List[Tuple[float, float]] = []
        self._ckpt_queue: Optional[queue.Queue] = None
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_errors: List[BaseException] = []
        self._ckpt_slots = threading.BoundedSemaphore(self.CKPT_SNAPSHOTS)
        install_gc_spans()

    # -- job lifecycle ------------------------------------------------- #
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
        run.params, run.opt, run.batch = self._distribute(
            state if state is not None
            else _make_state(run.spec, self.device))
        run.started = True
        return run

    def _distribute(self, state: tuple) -> tuple:
        """(params, opt, batch) as DTensors on ``rules.mesh`` (unchanged
        without rules): parameters and moments at the parameters'
        placements, the batch over the batch axes."""
        if self.rules is None:
            return state
        from repro_torch.launch import specs
        from repro_torch.sharding.rules import distribute_tree
        params, opt, batch = state
        mesh = self.rules.mesh
        pl = specs.param_shardings(self.rules, params)
        return (distribute_tree(mesh, params, pl),
                OptState(step=opt.step, m=distribute_tree(mesh, opt.m, pl),
                         v=distribute_tree(mesh, opt.v, pl)),
                distribute_tree(mesh, batch,
                                specs.batch_shardings(self.rules, batch)))

    def _ctx(self):
        if self.rules is None:
            import contextlib
            return contextlib.nullcontext()
        from repro_torch.sharding.hooks import activation_rules
        return activation_rules(self.rules.activation_table(),
                                rules=self.rules)

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

    # -- checkpoint / restart ------------------------------------------ #
    def _ckpt_path(self, name: str) -> str:
        assert self.checkpoint_dir is not None
        return os.path.join(self.checkpoint_dir,
                            f"{name}{self.checkpoint_tag}.npz")

    def _ckpt_worker(self) -> None:
        q = self._ckpt_queue
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                return
            path, tree, snapshot_s = item
            del item
            try:
                t0 = time.perf_counter()
                _ckpt.save_pytree(path, tree)
                self.checkpoint_seconds.append(
                    (snapshot_s, time.perf_counter() - t0))
                self.checkpoints_written += 1
            except Exception as exc:       # surfaced at the next flush
                self._ckpt_errors.append(exc)
            finally:
                del tree
                self._ckpt_slots.release()
                q.task_done()

    def checkpoint(self, name: str) -> str:
        """Snapshot ``name``'s params/opt/step to its checkpoint file.
        The device->host copy is made here and has finished when this
        returns: the next group step updates params and moments in place.
        The npz write and its CRC run on a background thread, so training
        does not wait on the disk; the write itself is atomic (tmp +
        fsync + rename, ``checkpoint.npz``). When ``CKPT_SNAPSHOTS``
        snapshots are already held, this waits until the writer has
        finished one before it takes its own."""
        if self.checkpoint_dir is None:
            raise RuntimeError("executor has no checkpoint_dir")
        run = self.runs[name]
        if not run.started:
            raise RuntimeError(f"job {name!r} not started")

        def host(tree):
            from repro_torch.sharding.rules import full_tree
            return tree_map(lambda t: t.detach().to("cpu", copy=True),
                            full_tree(tree))

        self._ckpt_slots.acquire()     # waits while the writer is behind
        try:
            t0 = time.perf_counter()
            snap = {"params": host(run.params), "step": run.steps_done}
            if run.opt is not None:
                snap["opt"] = OptState(step=run.opt.step, m=host(run.opt.m),
                                       v=host(run.opt.v))
            snapshot_s = time.perf_counter() - t0
        except BaseException:
            self._ckpt_slots.release()
            raise
        if self._ckpt_queue is None:
            self._ckpt_queue = queue.Queue()
            self._ckpt_thread = threading.Thread(
                target=self._ckpt_worker, daemon=True)
            self._ckpt_thread.start()
        path = self._ckpt_path(name)
        self._ckpt_queue.put((path, snap, snapshot_s))
        run.last_ckpt_step = run.steps_done
        return path

    def flush_checkpoints(self) -> None:
        """Block until every queued checkpoint write has landed; re-raise
        the first background write error, if any."""
        if self._ckpt_queue is not None:
            self._ckpt_queue.join()
        if self._ckpt_errors:
            raise self._ckpt_errors[0]

    def close(self) -> None:
        """Drain and join the background checkpoint writer (a flush
        leaves it parked on its queue). Idempotent; re-raises the first
        background write error like :meth:`flush_checkpoints`."""
        q, t = self._ckpt_queue, self._ckpt_thread
        self._ckpt_queue = None
        self._ckpt_thread = None
        if q is not None:
            q.join()                 # all queued writes landed
            q.put(None)              # stop sentinel
            if t is not None:
                t.join()
        if self._ckpt_errors:
            raise self._ckpt_errors[0]

    def __enter__(self) -> "ScheduleExecutor":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # don't mask an in-flight exception with a flush error
        try:
            self.close()
        except Exception:
            if exc_type is None:
                raise

    def restore_run(self, name: str, path: str) -> JobRun:
        """Load params/opt/step from an explicit checkpoint file into a
        started run, in place. CRC-verified by the checkpoint layer;
        raises CheckpointError on bit-rot."""
        run = self.runs[name]
        if not run.started:
            raise RuntimeError(f"job {name!r} not started")
        from repro_torch.sharding.rules import full_tree
        params, opt, step = _ckpt.restore(
            path, params_like=full_tree(run.params),
            opt_like=OptState(step=run.opt.step, m=full_tree(run.opt.m),
                              v=full_tree(run.opt.v)))
        run.params, run.opt, _ = self._distribute((params, opt, {}))
        run.steps_done = step
        run.last_ckpt_step = step
        return run

    def restart(self, name: str) -> JobRun:
        """Recover a failed (or stopped) job: pending checkpoint writes
        are flushed, the failed run's tensors released, the state rebuilt
        from the job's seed as :meth:`start` builds it, and params/opt/
        step restored from the job's last checkpoint, or left fresh when
        it never checkpointed. The batch is the job's fixed one, so a
        restart replays the remaining steps bit-exactly."""
        run = self.runs[name]
        if not run.started:
            raise RuntimeError(f"job {name!r} not started")
        self.flush_checkpoints()
        # old and new state would otherwise sit on the device together;
        # the last metrics stay, so the report keeps its loss
        run.params = run.opt = run.batch = None
        params, opt, batch = _make_state(run.spec, self.device)
        path = (self._ckpt_path(name)
                if self.checkpoint_dir is not None else None)
        if path is not None and os.path.exists(path):
            params, opt, run.steps_done = _ckpt.restore(
                path, params_like=params, opt_like=opt)
        else:
            run.steps_done = 0
        run.params, run.opt, run.batch = self._distribute(
            (params, opt, batch))
        run.failed = False
        run.restarts += 1
        return run

    # -- execution ----------------------------------------------------- #
    def step_group(self, names: Sequence[str]) -> Dict[str, Any]:
        """One group call advancing every named job one step. Returns the
        call's walltime and per-job losses.

        Fault path: the injector (if any) is consulted *before* the
        call, while no parameter has been touched. Transient faults retry
        with bounded backoff; a fatal fault (or an exhausted retry
        budget) marks the faulting member ``failed`` and returns
        ``{"dropped": name}``: the caller drops it and keeps stepping the
        survivors."""
        runs = [self.runs[n] for n in names]
        for r in runs:
            if not r.started or r.finished or r.failed:
                raise RuntimeError(f"job {r.name!r} not running")
        prog = make_group_step(
            [dataclasses.replace(r.spec, accum_steps=r.accum_steps)
             for r in runs])

        def attempt():
            if self.fault_injector is not None:
                self.fault_injector.check(self.calls, names)
            args: List[Any] = []
            for r in runs:
                args += [r.params, r.opt, r.batch]
            with span("repro_torch.executor.step_group"):
                self._sync()
                t0 = time.perf_counter()
                with self._ctx():
                    out = prog(*args)
                self._sync()
                dt = time.perf_counter() - t0
            return out, dt

        def note_retry(attempt_i, exc, delay):
            self.retries_total += 1
            self.runs[exc.job].retries += 1

        try:
            out, dt = retry_call(attempt, policy=self.retry_policy,
                                 retry_on=(TransientFault,),
                                 rng=self._retry_rng, sleep=self._sleep,
                                 on_retry=note_retry)
        except (TransientFault, FatalFault) as exc:
            self.runs[exc.job].failed = True
            self.drops_total += 1
            return {"walltime": 0.0, "losses": {}, "dropped": exc.job}
        losses = {}
        for i, r in enumerate(runs):
            r.params, r.opt, r.last_metrics = out[3 * i:3 * i + 3]
            r.steps_done += 1
            losses[r.name] = float(r.last_metrics["loss"])
            if (self.checkpoint_dir is not None and self.checkpoint_every
                    and r.steps_done % self.checkpoint_every == 0):
                self.checkpoint(r.name)
        self.calls += 1
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

    def execute(self, plan: "SchedulePlan | Sequence[PlanPhase]",
                ) -> Dict[str, Dict[str, Any]]:
        """Run a schedule plan to completion and return the per-job
        report: measured execution seconds (each group phase's walltime
        attributed to every running member), steps, final sub-batch, and,
        when the plan carries simulator predictions, the
        predicted-vs-measured error. A member dropped by a fault leaves
        its group (degraded mode); the survivors keep their quotas."""
        phases = plan.phases if isinstance(plan, SchedulePlan) else plan
        for phase in phases:
            for op in phase.ops:
                self._apply(op)
            quotas = dict(phase.quotas)
            for group in phase.groups:
                left = {n: quotas.get(n, 0) for n in group
                        if quotas.get(n, 0) > 0 and not self.runs[n].failed}
                t_group = 0.0
                while left:
                    members = sorted(left)
                    res = self.step_group(members)
                    dropped = res.get("dropped")
                    if dropped is not None:
                        del left[dropped]
                        continue
                    t_group += res["walltime"]
                    for n in members:
                        left[n] -= 1
                        if left[n] == 0:
                            del left[n]
                for n in group:
                    run = self.runs[n]
                    if run.started and not run.finished and not run.failed:
                        run.walltime += t_group
        report = {name: run.report() for name, run in self.runs.items()}
        if isinstance(plan, SchedulePlan):
            for name, pred in plan.predicted.items():
                rep = report.get(name)
                if rep is None:
                    continue
                rep["predicted_exec"] = pred["exec_seconds"]
                rep["measured_exec"] = rep["walltime"]
                if pred["exec_seconds"] > 0:
                    rep["error"] = (rep["walltime"] - pred["exec_seconds"]
                                    ) / pred["exec_seconds"]
        return report


# ---------------------------------------------------------------------- #
# Simulator-log replay: schedule -> executable plan
# ---------------------------------------------------------------------- #
def _components(placements: Mapping[int, frozenset]) -> List[List[int]]:
    """Connected components of the sharing graph: jobs sharing any GPU
    (directly or transitively) execute as one time-multiplexed group."""
    parent: Dict[int, int] = {j: j for j in placements}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    by_gpu: Dict[int, List[int]] = {}
    for jid, gpus in placements.items():
        for g in gpus:
            by_gpu.setdefault(g, []).append(jid)
    for tenants in by_gpu.values():
        for other in tenants[1:]:
            ra, rb = find(tenants[0]), find(other)
            if ra != rb:
                parent[rb] = ra
    comps: Dict[int, List[int]] = {}
    for j in placements:
        comps.setdefault(find(j), []).append(j)
    return [sorted(c) for c in comps.values()]


def plan_from_sim(log: Sequence[tuple], jobs: Mapping[int, Any],
                  interference, gpu_capacity_bytes: float,
                  *, names: Optional[Mapping[int, str]] = None,
                  ) -> SchedulePlan:
    """Translate a ``core.simulator.Simulator`` event log into an
    executable :class:`SchedulePlan` (the reference's ``plan_from_sim``,
    same arithmetic).

    The log's ``start``/``config``/``reconfig``/``finish`` entries become
    plan ops; between events, each running job's simulated progress
    (rate x interval, with the rate re-derived from its PerfParams
    sub-batch timing and the max-xi-over-co-runners rule the engine
    uses) accrues fractionally and is emitted as integer step quotas by
    cumulative rounding, so every job executes exactly ``job.iters``
    steps by its finish event. Sharing groups are the connected
    components of GPU co-tenancy. ``jobs`` maps jid -> the simulated
    ``core.job.Job``; ``names`` optionally renames jobs for the executor
    (default ``job<jid>``)."""
    names = names or {}

    def name_of(jid: int) -> str:
        return names.get(jid, f"job{jid}")

    placements: Dict[int, frozenset] = {}
    sub_batch: Dict[int, int] = {}
    cum: Dict[int, float] = {}
    emitted: Dict[int, int] = {}

    def rate(jid: int) -> float:
        job = jobs[jid]
        base = job.perf.t_iter_sub(job.batch, sub_batch[jid])
        xi = 1.0
        others = set()
        for g in placements[jid]:
            for other in by_gpu.get(g, ()):
                if other != jid:
                    others.add(other)
        for other in others:
            oj = jobs[other]
            mem = (job.perf.mem_bytes(sub_batch[jid])
                   + oj.perf.mem_bytes(sub_batch[other]))
            xi = max(xi, interference.xi(
                job.model, oj.model, t_me=base,
                t_other=oj.perf.t_iter_sub(oj.batch, sub_batch[other]),
                mem_frac=mem / gpu_capacity_bytes))
        return 1.0 / (base * xi)

    # group log entries by timestamp (the log is time-ordered)
    times: List[float] = []
    grouped: List[List[tuple]] = []
    for entry in log:
        if not times or entry[0] > times[-1] + 1e-12:
            times.append(entry[0])
            grouped.append([entry])
        else:
            grouped[-1].append(entry)

    phases: List[PlanPhase] = []
    predicted: Dict[str, Dict[str, float]] = {}
    by_gpu: Dict[int, set] = {}

    for k, (t, entries) in enumerate(zip(times, grouped)):
        ops: List[PlanOp] = []
        # finishes first (they free GPUs), then starts/reconfigs — the
        # engines order completions before the scheduling pass too
        for entry in sorted(entries, key=lambda e: e[1] != "finish"):
            kind, jid = entry[1], entry[2]
            if kind == "finish":
                job = jobs[jid]
                ops.append(PlanOp("finish", name_of(jid)))
                predicted[name_of(jid)] = {
                    "exec_seconds": job.finish_time - job.start_time,
                    "jct": job.jct(),
                }
                for g in placements.pop(jid, ()):
                    by_gpu[g].discard(jid)
            elif kind == "start":
                placements[jid] = frozenset(entry[3])
                for g in entry[3]:
                    by_gpu.setdefault(g, set()).add(jid)
                cum.setdefault(jid, 0.0)
                emitted.setdefault(jid, 0)
            elif kind == "config":
                sub_batch[jid] = int(entry[3])
                ops.append(PlanOp("start", name_of(jid),
                                  sub_batch=int(entry[3])))
            elif kind == "reconfig":
                sub_batch[jid] = int(entry[3])
                ops.append(PlanOp("reconfig", name_of(jid),
                                  sub_batch=int(entry[3])))
            elif kind in ("preempt", "fail_job", "fail_server",
                          "recover_server"):
                raise ValueError(
                    "plan_from_sim only replays non-preemptive, "
                    f"fault-free schedules (saw {kind!r})")
        # accrue simulated progress until the next event
        dt = (times[k + 1] - t) if k + 1 < len(times) else 0.0
        quotas: List[Tuple[str, int]] = []
        if placements and dt > 0:
            rates = {jid: rate(jid) for jid in placements}
            for jid in sorted(placements):
                job = jobs[jid]
                cum[jid] = min(float(job.iters), cum[jid] + rates[jid] * dt)
                # cumulative rounding: totals land on job.iters exactly
                # (the snap tolerance mirrors the engines' relative
                # _FINISH_TOL so a logged finish always tops up)
                target = int(round(cum[jid]))
                if cum[jid] >= job.iters - 1e-6 * max(1.0, job.iters):
                    target = int(round(job.iters))
                q = target - emitted[jid]
                emitted[jid] = target
                quotas.append((name_of(jid), q))
            groups = tuple(tuple(name_of(j) for j in comp)
                           for comp in _components(placements))
        else:
            groups = ()
        phases.append(PlanPhase(ops=tuple(ops), quotas=tuple(quotas),
                                groups=groups, sim_duration=dt))
    return SchedulePlan(phases=phases, predicted=predicted)
