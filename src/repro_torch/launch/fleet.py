"""Master/agent multi-host cluster runtime (the reference's
``launch/fleet.py``).

The ScheduleExecutor runs a whole simulated SJF-BSBF schedule on
ONE host, group by group. This module is the next layer up: a **master**
process that replays a full :func:`plan_from_sim` schedule by *leasing*
sharing groups onto N **agent** processes (process-per-server emulation
over localhost TCP; the lease/heartbeat protocol is transport-agnostic,
so a multi-host deployment swaps the socket for a real network without
touching the state machine). Each agent runs the executor's group steps
on its device (``FleetConfig.device``: the card unless ``"cpu"``; on one
card every agent shares it); job state crosses processes only through
the shared CRC-verified checkpoint directory. Each lease also carries the
autotuning table installed in the master's process (or none), which the
agent installs before it steps, so agents route their kernels as the
master's own process would.

Robustness is the headline. Real multi-tenant clusters lose workers
constantly (Philly: Jeon et al. 1901.05758 attributes a large share of
job failures to infrastructure), so the master assumes agents die:

* **Heartbeats with progress watermarks** — every agent reports
  ``{job: steps_done}`` on a fixed interval; the master asserts the
  watermark is monotone per lease epoch.
* **Suspect -> dead state machine** — an agent missing heartbeats for
  ``suspect_after`` seconds is SUSPECT (logged, still leased); after
  ``dead_after`` it is DEAD: its leases are revoked and re-dispatched.
  A socket EOF from a *confirmed-exited* process short-circuits straight
  to DEAD (SIGKILL detection is near-instant); EOF from a process the
  master cannot confirm dead only raises SUSPECT — a half-open
  connection is not a death certificate.
* **Lease epochs + fencing** — every lease carries a fresh monotonically
  increasing epoch; agents write checkpoints into per-epoch files
  (``job.e0007.npz``). Results or heartbeats tagged with a revoked epoch
  are discarded (counted in ``stats["fenced"]``), and a fenced epoch's
  checkpoint files are never named in a later lease's
  ``restore_epochs`` — a zombie agent (SIGSTOPped through its timeout,
  then resumed) can neither report stale work nor poison recovery state.
* **Recovery** — a re-dispatched lease restarts each member bit-exactly
  from its best valid-epoch checkpoint (``ScheduleExecutor.restore_run``),
  or,
  with ``recovery="degrade"``, drops members that never checkpointed and
  re-fuses the survivors. Dispatch itself retries with
  ``repro_torch.util.retry`` full-jitter backoff under an overall wall-clock
  ``deadline`` (:class:`RetryBudgetExceeded` caps a group's recovery
  budget).
* **Chaos** — :class:`ChaosKiller` SIGKILLs/SIGSTOPs agents when their
  progress watermark crosses a scripted threshold, the fleet-tier
  analogue of the executor's ScriptedFaults: the same spec replays the
  same failure scenario.

The master doubles as an mgpu_server-shaped job service (submit / queue
/ cancel / status over the same socket) for the ``repro-torch-fleet`` CLI (``launch/fleet_cli.py``).
"""
from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.kernels import autotune
from repro_torch.launch.cluster import JobSpec, SchedulePlan
from repro_torch.launch.wire import (MessageReader, WireError, send_msg,
                                     spec_to_wire)
from repro_torch.util.retry import RetryPolicy, retry_call

__all__ = ["AgentHandle", "ChaosKiller", "FleetConfig", "FleetError",
           "FleetMaster", "KillSpec", "Lease", "MasterJob"]


class FleetError(RuntimeError):
    """The fleet could not make progress (no agents, phase timeout, or
    an agent reported an unrecoverable lease error)."""


# --------------------------------------------------------------------- #
# Chaos injection: scripted agent kills
# --------------------------------------------------------------------- #
@dataclass
class KillSpec:
    """Kill ``agent`` once its total progress watermark (steps summed
    over the jobs it is stepping) reaches ``after_steps``. ``sig``
    defaults to SIGKILL (hard crash mid-step); SIGSTOP scripts a zombie
    — alive but silent, which must trip the heartbeat timeout and then
    be fenced if it ever resumes."""

    agent: str
    after_steps: int = 1
    sig: int = signal.SIGKILL


class ChaosKiller:
    """Deterministic agent-kill injector, consulted by the master on
    every heartbeat. Fleet-tier sibling of the executor's
    ScriptedFaults."""

    def __init__(self, specs: Sequence[KillSpec]) -> None:
        self._specs = list(specs)
        self.kills: List[Dict[str, Any]] = []

    def maybe_kill(self, agent_id: str, pid: Optional[int],
                   total_steps: int) -> Optional[KillSpec]:
        for spec in list(self._specs):
            if spec.agent == agent_id and total_steps >= spec.after_steps:
                self._specs.remove(spec)
                if pid is not None:
                    os.kill(pid, spec.sig)
                self.kills.append({"agent": agent_id, "t": time.monotonic(),
                                   "at_steps": total_steps,
                                   "sig": int(spec.sig)})
                return spec
        return None


# --------------------------------------------------------------------- #
# Master-side bookkeeping records
# --------------------------------------------------------------------- #
@dataclass
class FleetConfig:
    heartbeat_interval: float = 0.25
    suspect_after: float = 0.75     # no heartbeat for this long -> SUSPECT
    dead_after: float = 1.5         # -> DEAD: revoke + re-dispatch
    checkpoint_every: int = 1       # agent-side steps between checkpoints
    step_sleep: float = 0.0         # agent pause between fused calls
    recovery: str = "restart"       # "restart" | "degrade"
    respawn: bool = False           # replace dead agents
    retry_policy: RetryPolicy = field(default_factory=lambda: RetryPolicy(
        attempts=6, base=0.05, cap=0.5, deadline=30.0))
    phase_timeout: float = 600.0    # wall-clock cap per plan phase
    spawn_timeout: float = 120.0    # agent hello deadline (torch import)
    retry_seed: int = 0
    device: Optional[str] = None    # the agents' device: None = the card

    def __post_init__(self) -> None:
        if self.recovery not in ("restart", "degrade"):
            raise ValueError(f"unknown recovery mode {self.recovery!r}")


@dataclass
class AgentHandle:
    id: str
    sock: Optional[socket.socket] = None
    proc: Optional[subprocess.Popen] = None
    state: str = "connecting"       # connecting|alive|suspect|dead
    last_hb: float = 0.0
    kill_time: Optional[float] = None
    watermark: Dict[str, int] = field(default_factory=dict)
    leases: set = field(default_factory=set)
    send_lock: threading.Lock = field(default_factory=threading.Lock)

    def confirmed_exited(self) -> bool:
        return self.proc is not None and self.proc.poll() is not None


@dataclass
class MasterJob:
    name: str
    wire_spec: Dict[str, Any]
    total_steps: int
    sub_batch: Optional[int] = None
    steps_done: int = 0
    started: bool = False
    finished: bool = False
    failed: bool = False
    cancelled: bool = False
    queued: bool = False            # service mode: awaiting dispatch
    valid_epochs: List[int] = field(default_factory=list)
    crc: Optional[int] = None
    loss: Optional[float] = None
    walltime: float = 0.0
    redispatches: int = 0

    def report(self) -> Dict[str, Any]:
        return {"steps": self.steps_done, "total_steps": self.total_steps,
                "walltime": self.walltime, "sub_batch": self.sub_batch,
                "finished": self.finished, "failed": self.failed,
                "cancelled": self.cancelled, "crc": self.crc,
                "loss": self.loss, "redispatches": self.redispatches}


@dataclass
class Lease:
    id: int
    epoch: int
    agent_id: str
    members: Tuple[str, ...]
    targets: Dict[str, int]          # name -> end step
    start_steps: Dict[str, int]      # name -> steps_done at dispatch
    plan_group: Tuple[str, ...]      # full group incl. zero-quota members
    status: str = "active"           # active|done|lost|error
    service: bool = False
    error: str = ""
    dispatched_t: float = 0.0


# --------------------------------------------------------------------- #
class FleetMaster:
    """Owns the agent fleet, the lease ledger, and the heartbeat state
    machine. Thread layout: an accept loop (one reader thread per
    connection), a monitor loop (timeout state machine + service-queue
    dispatch), and the caller's thread driving :meth:`run_plan` /
    :meth:`serve_forever`. All shared state sits behind one condition
    variable."""

    def __init__(self, checkpoint_dir: str, *,
                 config: Optional[FleetConfig] = None,
                 chaos: Optional[ChaosKiller] = None) -> None:
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.cfg = config or FleetConfig()
        self.chaos = chaos
        self.agents: Dict[str, AgentHandle] = {}
        self.jobs: Dict[str, MasterJob] = {}
        self.leases: Dict[int, Lease] = {}
        self.events: List[Dict[str, Any]] = []
        self.stats = {"redispatches": 0, "fenced": 0, "respawns": 0,
                      "steps_executed": 0, "steps_lost": 0,
                      "watermark_regressions": 0}
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._epoch = 0
        self._lease_ids = iter(range(1, 1 << 31))
        self._fenced_epochs: set = set()
        self._rng = random.Random(self.cfg.retry_seed)
        self._server: Optional[socket.socket] = None
        self._closing = False
        self._threads: List[threading.Thread] = []
        self._agent_seq = 0
        self._service_queue: List[str] = []   # job names awaiting dispatch
        self.port: Optional[int] = None

    # -- lifecycle ----------------------------------------------------- #
    def start(self, n_agents: int = 0) -> "FleetMaster":
        self._server = socket.create_server(("127.0.0.1", 0))
        self.port = self._server.getsockname()[1]
        for target in (self._accept_loop, self._monitor_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        for _ in range(n_agents):
            self.spawn_agent()
        if n_agents:
            self.wait_for_agents(n_agents)
        return self

    def spawn_agent(self, agent_id: Optional[str] = None) -> str:
        """Launch one agent subprocess pointed at this master, on
        ``config.device``. Its stdout/stderr stream into
        ``<ckpt_dir>/<id>.log``. A CPU agent takes this process's torch
        thread count, so its sums run in the order this process's do."""
        import torch

        import repro_torch
        with self._lock:
            if agent_id is None:
                agent_id = f"a{self._agent_seq}"
                self._agent_seq += 1
        # the source root holds the repro_torch package
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        log = open(os.path.join(self.checkpoint_dir, f"{agent_id}.log"),
                   "ab")
        cmd = [sys.executable, "-m", "repro_torch.launch.agent",
               "--host", "127.0.0.1", "--port", str(self.port),
               "--id", agent_id,
               "--heartbeat", str(self.cfg.heartbeat_interval)]
        if self.cfg.device is not None:
            cmd += ["--device", str(self.cfg.device)]
            if torch.device(self.cfg.device).type == "cpu":
                cmd += ["--threads", str(torch.get_num_threads())]
        proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=log,
                                close_fds=True)
        log.close()
        with self._lock:
            handle = self.agents.get(agent_id)
            if handle is None:
                handle = AgentHandle(id=agent_id)
                self.agents[agent_id] = handle
            handle.proc = proc
            handle.state = "connecting"
        return agent_id

    def wait_for_agents(self, n: int, timeout: Optional[float] = None
                        ) -> None:
        deadline = time.monotonic() + (timeout or self.cfg.spawn_timeout)
        with self._cond:
            while sum(1 for a in self.agents.values()
                      if a.state == "alive") < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise FleetError(
                        f"{n} agent(s) did not register within "
                        f"{timeout or self.cfg.spawn_timeout:.0f}s")
                self._cond.wait(min(left, 0.1))

    def shutdown(self) -> None:
        with self._lock:
            if self._closing:
                return
            self._closing = True
            handles = list(self.agents.values())
        for h in handles:
            if h.sock is not None:
                try:
                    send_msg(h.sock, {"type": "shutdown"}, h.send_lock)
                except WireError:
                    pass
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
        for h in handles:
            if h.proc is not None:
                try:
                    h.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    h.proc.kill()
                    h.proc.wait()
            if h.sock is not None:
                try:
                    h.sock.close()
                except OSError:
                    pass

    def __enter__(self) -> "FleetMaster":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown()

    # -- event log ----------------------------------------------------- #
    def _event(self, kind: str, **kw) -> None:
        self.events.append({"t": time.monotonic(), "kind": kind, **kw})

    # -- connection plumbing ------------------------------------------- #
    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            t = threading.Thread(target=self._conn_loop, args=(sock,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _conn_loop(self, sock: socket.socket) -> None:
        reader = MessageReader(sock)
        try:
            hello = reader.read()
        except WireError:
            hello = None
        if hello is None or hello.get("type") != "hello":
            sock.close()
            return
        if hello.get("role") == "client":
            self._serve_client(sock, reader)
            return
        agent_id = str(hello.get("id"))
        with self._cond:
            handle = self.agents.get(agent_id)
            if handle is None:
                handle = AgentHandle(id=agent_id)
                self.agents[agent_id] = handle
            handle.sock = sock
            handle.state = "alive"
            handle.last_hb = time.monotonic()
            self._event("agent_up", agent=agent_id,
                        pid=hello.get("pid"))
            self._cond.notify_all()
        while True:
            try:
                msg = reader.read()
            except WireError:
                msg = None
            if msg is None:
                self._on_agent_eof(handle)
                return
            self._on_agent_msg(handle, msg)

    # -- agent message handling ---------------------------------------- #
    def _on_agent_msg(self, handle: AgentHandle, msg: Dict[str, Any]
                      ) -> None:
        kind = msg.get("type")
        if kind == "heartbeat":
            self._on_heartbeat(handle, msg)
        elif kind in ("lease_done", "lease_error"):
            self._on_lease_result(handle, msg)

    def _on_heartbeat(self, handle: AgentHandle, msg: Dict[str, Any]
                      ) -> None:
        epoch = msg.get("epoch")
        wm = {str(k): int(v) for k, v in (msg.get("watermark") or
                                          {}).items()}
        kill_pid = None
        with self._cond:
            if handle.state == "dead":
                # a zombie past its timeout: fenced, not resurrected
                self.stats["fenced"] += 1
                return
            handle.last_hb = time.monotonic()
            if handle.state == "suspect":
                handle.state = "alive"
                self._event("agent_recovered", agent=handle.id)
            if epoch is not None and epoch in self._fenced_epochs:
                self.stats["fenced"] += 1
                return
            for name, steps in wm.items():
                prev = handle.watermark.get(name, -1)
                if steps < prev:
                    self.stats["watermark_regressions"] += 1
                handle.watermark[name] = steps
            total = sum(handle.watermark.values())
            if self.chaos is not None and handle.proc is not None:
                kill_pid = handle.proc.pid
            self._cond.notify_all()
        if kill_pid is not None:
            spec = self.chaos.maybe_kill(handle.id, kill_pid, total)
            if spec is not None:
                with self._cond:
                    handle.kill_time = time.monotonic()
                    self._event("chaos_kill", agent=handle.id,
                                sig=int(spec.sig), at_steps=total)

    def _on_lease_result(self, handle: AgentHandle, msg: Dict[str, Any]
                         ) -> None:
        with self._cond:
            lease = self.leases.get(msg.get("lease_id"))
            if (lease is None or lease.status != "active"
                    or msg.get("epoch") != lease.epoch
                    or lease.epoch in self._fenced_epochs):
                self.stats["fenced"] += 1
                self._event("fenced_result", agent=handle.id,
                            lease=msg.get("lease_id"),
                            epoch=msg.get("epoch"))
                return
            handle.leases.discard(lease.id)
            if msg["type"] == "lease_error":
                lease.status = "error"
                lease.error = str(msg.get("error", ""))
                self._event("lease_error", lease=lease.id,
                            agent=handle.id, error=lease.error)
                self._cond.notify_all()
                return
            lease.status = "done"
            report = msg.get("report", {})
            walltime = float(msg.get("walltime", 0.0))
            for name in lease.plan_group:
                job = self.jobs.get(name)
                if job is not None and job.started and not job.finished:
                    job.walltime += walltime
            for name in lease.members:
                job = self.jobs.get(name)
                rep = report.get(name)
                if job is None or rep is None:
                    continue
                job.steps_done = int(rep["steps"])
                job.crc = rep.get("crc")
                if rep.get("loss") is not None:
                    job.loss = float(rep["loss"])
                job.valid_epochs.append(lease.epoch)
                self.stats["steps_executed"] += (
                    int(rep["steps"]) - int(rep.get("resumed_from", 0)))
                if lease.service and job.steps_done >= job.total_steps:
                    job.finished = True
            self._event("lease_done", lease=lease.id, agent=handle.id,
                        epoch=lease.epoch, walltime=walltime)
            self._cond.notify_all()

    # -- failure detection --------------------------------------------- #
    def _on_agent_eof(self, handle: AgentHandle) -> None:
        """Reader saw EOF. A confirmed-exited process is DEAD now; an
        unconfirmed one is only SUSPECT — the heartbeat timeout (or a
        later exit confirmation) finishes the job."""
        with self._cond:
            if handle.state == "dead" or self._closing:
                return
            if handle.confirmed_exited():
                self._mark_dead(handle, reason="exit")
            elif handle.state == "alive":
                handle.state = "suspect"
                self._event("agent_suspect", agent=handle.id,
                            reason="eof")
            self._cond.notify_all()

    def _monitor_loop(self) -> None:
        interval = min(0.05, self.cfg.heartbeat_interval / 4)
        while not self._closing:
            time.sleep(interval)
            now = time.monotonic()
            with self._cond:
                for handle in list(self.agents.values()):
                    if handle.state not in ("alive", "suspect"):
                        continue
                    silent = now - handle.last_hb
                    if handle.sock is None:
                        continue
                    if (handle.state == "alive"
                            and silent > self.cfg.suspect_after):
                        handle.state = "suspect"
                        self._event("agent_suspect", agent=handle.id,
                                    reason="heartbeat", silent=silent)
                    if silent > self.cfg.dead_after or (
                            handle.state == "suspect"
                            and handle.confirmed_exited()):
                        self._mark_dead(
                            handle,
                            reason=("exit" if handle.confirmed_exited()
                                    else "heartbeat"))
                self._dispatch_service_queue()
                self._cond.notify_all()

    def _mark_dead(self, handle: AgentHandle, *, reason: str) -> None:
        """State machine sink (callers hold the lock): revoke the dead
        agent's leases, fence its epochs unless the process provably
        exited, and flag the leases for re-dispatch."""
        if handle.state == "dead":
            return
        handle.state = "dead"
        now = time.monotonic()
        anchor = handle.kill_time if handle.kill_time is not None \
            else handle.last_hb
        latency = max(0.0, now - anchor)
        self._event("agent_dead", agent=handle.id, reason=reason,
                    detection_latency=latency,
                    killed=handle.kill_time is not None)
        trusted = handle.confirmed_exited()
        for lease_id in sorted(handle.leases):
            lease = self.leases.get(lease_id)
            if lease is None or lease.status != "active":
                continue
            lease.status = "lost"
            if trusted:
                # writes that landed before the crash are authoritative
                for name in lease.members:
                    job = self.jobs.get(name)
                    if job is not None:
                        job.valid_epochs.append(lease.epoch)
            else:
                self._fenced_epochs.add(lease.epoch)
            for name in lease.members:
                got = handle.watermark.get(name,
                                           lease.start_steps[name])
                self.stats["steps_lost"] += max(
                    0, got - lease.start_steps[name])
            self._event("lease_lost", lease=lease.id, agent=handle.id,
                        epoch=lease.epoch, fenced=not trusted)
        handle.leases.clear()
        if self.cfg.respawn and not self._closing:
            self.stats["respawns"] += 1
            threading.Thread(target=self.spawn_agent,
                             daemon=True).start()

    # -- lease dispatch ------------------------------------------------ #
    def _pick_agent(self) -> AgentHandle:
        alive = [a for a in self.agents.values() if a.state == "alive"]
        if not alive:
            raise FleetError("no alive agents")
        return min(alive, key=lambda a: (len(a.leases), a.id))

    def _next_epoch(self) -> int:
        self._epoch += 1
        return self._epoch

    def _send_lease(self, lease: Lease, handle: AgentHandle) -> None:
        members = []
        for name in lease.members:
            job = self.jobs[name]
            members.append({
                "name": name,
                "spec": job.wire_spec,
                "total_steps": job.total_steps,
                "sub_batch": job.sub_batch,
                "end_step": lease.targets[name],
                "restore_epochs": [e for e in job.valid_epochs
                                   if e not in self._fenced_epochs],
            })
        send_msg(handle.sock, {
            "type": "lease", "lease_id": lease.id, "epoch": lease.epoch,
            "ckpt_dir": self.checkpoint_dir,
            "checkpoint_every": self.cfg.checkpoint_every,
            "step_sleep": self.cfg.step_sleep,
            "members": members,
            "autotune": (None if autotune.get_table() is None
                         else autotune.get_table().payload),
        }, handle.send_lock)

    def _dispatch(self, members: Tuple[str, ...],
                  targets: Dict[str, int],
                  plan_group: Tuple[str, ...], *,
                  service: bool = False) -> Lease:
        """Create a fresh-epoch lease for ``members`` and place it on an
        alive agent, retrying with backoff (and an overall deadline)
        through transient dispatch failures — an agent dying between
        pick and send is exactly such a transient."""

        def attempt() -> Lease:
            with self._cond:
                handle = self._pick_agent()
                lease = Lease(
                    id=next(self._lease_ids), epoch=self._next_epoch(),
                    agent_id=handle.id, members=tuple(members),
                    targets=dict(targets),
                    start_steps={n: self.jobs[n].steps_done
                                 for n in members},
                    plan_group=tuple(plan_group), service=service,
                    dispatched_t=time.monotonic())
                try:
                    self._send_lease(lease, handle)
                except WireError as exc:
                    self._mark_dead(handle, reason="send-failed")
                    raise FleetError(str(exc)) from exc
                self.leases[lease.id] = lease
                handle.leases.add(lease.id)
                self._event("lease_dispatch", lease=lease.id,
                            agent=handle.id, epoch=lease.epoch,
                            members=list(members))
                return lease

        return retry_call(attempt, policy=self.cfg.retry_policy,
                          retry_on=(FleetError,), rng=self._rng)

    def _redispatch(self, lost: Lease) -> Optional[Lease]:
        """Re-dispatch a lost lease's group. In ``degrade`` mode,
        members that never reached a usable checkpoint are dropped
        (marked failed) and the survivors re-fuse; in ``restart`` mode
        every member restarts from its best checkpoint or, absent one,
        from step zero — bit-exact either way."""
        with self._lock:
            members = []
            for name in lost.members:
                job = self.jobs[name]
                if job.finished or job.failed or job.cancelled:
                    continue
                if self.cfg.recovery == "degrade" and not any(
                        self._has_checkpoint(name, e)
                        for e in job.valid_epochs
                        if e not in self._fenced_epochs):
                    job.failed = True
                    self._event("member_degraded", job=name,
                                lease=lost.id)
                    continue
                members.append(name)
            for name in members:
                self.jobs[name].redispatches += 1
        if not members:
            return None
        self.stats["redispatches"] += 1
        lease = self._dispatch(tuple(members),
                               {n: lost.targets[n] for n in members},
                               lost.plan_group, service=lost.service)
        self._event("lease_redispatch", old=lost.id, new=lease.id,
                    members=members)
        return lease

    def _has_checkpoint(self, name: str, epoch: int) -> bool:
        return os.path.exists(os.path.join(
            self.checkpoint_dir, f"{name}.e{epoch:04d}.npz"))

    # -- plan execution ------------------------------------------------ #
    def run_plan(self, plan: "SchedulePlan | Sequence",
                 specs: Mapping[str, JobSpec]) -> Dict[str, Dict]:
        """Execute a :class:`SchedulePlan` across the fleet: per phase,
        every sharing group becomes a lease placed on an agent (groups
        run concurrently — the whole simulated schedule executes, not
        one group at a time), with the failure machinery above keeping
        the phase running when agents die. Returns the per-job report,
        with simulator predictions joined when the plan carries them."""
        phases = plan.phases if isinstance(plan, SchedulePlan) else plan
        totals: Dict[str, int] = {}
        for phase in phases:
            for name, q in phase.quotas:
                totals[name] = totals.get(name, 0) + q
        with self._lock:
            for name, spec in specs.items():
                self.jobs[name] = MasterJob(
                    name=name, wire_spec=spec_to_wire(spec),
                    total_steps=totals.get(name, 0))
        for phase in phases:
            for op in phase.ops:
                self._apply_plan_op(op)
            with self._lock:
                targets: Dict[str, int] = {}
                for name, q in phase.quotas:
                    job = self.jobs[name]
                    if (q > 0 and job.started and not job.finished
                            and not job.failed):
                        targets[name] = job.steps_done + q
            leases = []
            for group in phase.groups:
                members = tuple(n for n in group if n in targets)
                if members:
                    leases.append(self._dispatch(
                        members, {n: targets[n] for n in members},
                        plan_group=tuple(group)))
            self._await_leases(leases)
        report = {name: job.report()
                  for name, job in sorted(self.jobs.items())}
        if isinstance(plan, SchedulePlan):
            for name, pred in plan.predicted.items():
                rep = report.get(name)
                if rep is not None:
                    rep["predicted_exec"] = pred["exec_seconds"]
        return report

    def _apply_plan_op(self, op) -> None:
        with self._lock:
            job = self.jobs[op.job]
            if op.kind == "start":
                job.started = True
                if op.sub_batch is not None:
                    job.sub_batch = int(op.sub_batch)
            elif op.kind == "reconfig":
                job.sub_batch = int(op.sub_batch)
            elif op.kind == "finish":
                if job.failed:
                    return
                if job.steps_done != job.total_steps:
                    raise FleetError(
                        f"job {op.job!r} finished at {job.steps_done}/"
                        f"{job.total_steps} steps")
                job.finished = True
            else:
                raise ValueError(f"unknown plan op {op.kind!r}")

    def _await_leases(self, leases: List[Lease]) -> None:
        """Block until every lease reaches a terminal state, re-
        dispatching lost ones as the monitor flags them. Bounded by
        ``phase_timeout`` so a wedged fleet fails loudly, never hangs."""
        pending = {l.id: l for l in leases}
        deadline = time.monotonic() + self.cfg.phase_timeout
        while pending:
            redo: List[Lease] = []
            with self._cond:
                for lease in list(pending.values()):
                    if lease.status == "done":
                        del pending[lease.id]
                    elif lease.status == "lost":
                        del pending[lease.id]
                        redo.append(lease)
                    elif lease.status == "error":
                        raise FleetError(
                            f"lease {lease.id} failed on agent "
                            f"{lease.agent_id}: {lease.error}")
                if not redo:
                    if not pending:
                        return
                    if time.monotonic() > deadline:
                        raise FleetError(
                            f"phase timed out after "
                            f"{self.cfg.phase_timeout:.0f}s with "
                            f"{len(pending)} lease(s) outstanding")
                    self._cond.wait(0.05)
            for lost in redo:
                fresh = self._redispatch(lost)
                if fresh is not None:
                    pending[fresh.id] = fresh

    # -- service mode (mgpu_server-shaped) ----------------------------- #
    def submit_job(self, wire_spec: Dict[str, Any], steps: int,
                   name: Optional[str] = None,
                   sub_batch: Optional[int] = None) -> str:
        with self._cond:
            if name is None:
                name = f"job{len(self.jobs)}"
            if name in self.jobs:
                raise FleetError(f"job {name!r} already submitted")
            job = MasterJob(name=name, wire_spec=wire_spec,
                            total_steps=int(steps), sub_batch=sub_batch,
                            started=True, queued=True)
            self.jobs[name] = job
            self._service_queue.append(name)
            self._event("submit", job=name, steps=int(steps))
            self._cond.notify_all()
        return name

    def _dispatch_service_queue(self) -> None:
        """Monitor-loop hook (lock held): lease queued jobs onto idle
        agents, requeue jobs whose lease was lost."""
        for lease in list(self.leases.values()):
            if lease.service and lease.status == "lost":
                lease.status = "requeued"
                for name in lease.members:
                    job = self.jobs.get(name)
                    if job and not (job.finished or job.cancelled
                                    or job.queued):
                        job.queued = True
                        job.redispatches += 1
                        self._service_queue.append(name)
                        self.stats["redispatches"] += 1
        while self._service_queue:
            idle = [a for a in self.agents.values()
                    if a.state == "alive" and not a.leases]
            if not idle:
                return
            name = self._service_queue[0]
            job = self.jobs[name]
            if job.cancelled or job.finished:
                self._service_queue.pop(0)
                job.queued = False
                continue
            handle = min(idle, key=lambda a: a.id)
            lease = Lease(
                id=next(self._lease_ids), epoch=self._next_epoch(),
                agent_id=handle.id, members=(name,),
                targets={name: job.total_steps},
                start_steps={name: job.steps_done},
                plan_group=(name,), service=True,
                dispatched_t=time.monotonic())
            try:
                self._send_lease(lease, handle)
            except WireError:
                self._mark_dead(handle, reason="send-failed")
                continue
            self._service_queue.pop(0)
            job.queued = False
            self.leases[lease.id] = lease
            handle.leases.add(lease.id)
            self._event("lease_dispatch", lease=lease.id,
                        agent=handle.id, epoch=lease.epoch,
                        members=[name], service=True)

    def cancel_job(self, name: str) -> bool:
        with self._cond:
            job = self.jobs.get(name)
            if job is None or job.finished or job.cancelled:
                return False
            job.cancelled = True
            job.queued = False
            if name in self._service_queue:
                self._service_queue.remove(name)
            for lease in self.leases.values():
                if lease.status == "active" and name in lease.members:
                    handle = self.agents.get(lease.agent_id)
                    if handle is not None and handle.sock is not None:
                        try:
                            send_msg(handle.sock,
                                     {"type": "cancel",
                                      "lease_id": lease.id},
                                     handle.send_lock)
                        except WireError:
                            pass
            self._event("cancel", job=name)
            return True

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "port": self.port,
                "agents": {a.id: {"state": a.state,
                                  "leases": sorted(a.leases),
                                  "watermark": dict(a.watermark)}
                           for a in self.agents.values()},
                "jobs": {n: j.report() for n, j in self.jobs.items()},
                "queue": list(self._service_queue),
                "stats": dict(self.stats),
            }

    def wait_for_job(self, name: str, timeout: float = 600.0) -> Dict:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                job = self.jobs[name]
                if job.finished or job.failed or job.cancelled:
                    return job.report()
                if time.monotonic() > deadline:
                    raise FleetError(f"job {name!r} did not finish in "
                                     f"{timeout:.0f}s")
                self._cond.wait(0.1)

    # -- client (CLI) connections -------------------------------------- #
    def _serve_client(self, sock: socket.socket,
                      reader: MessageReader) -> None:
        try:
            msg = reader.read()
            if msg is None:
                return
            kind = msg.get("type")
            if kind == "submit":
                try:
                    name = self.submit_job(
                        msg["spec"], int(msg["steps"]),
                        name=msg.get("name"),
                        sub_batch=msg.get("sub_batch"))
                    resp = {"ok": True, "job": name}
                except (FleetError, KeyError, ValueError) as exc:
                    resp = {"ok": False, "error": str(exc)}
            elif kind in ("status", "queue"):
                resp = {"ok": True, **self.status()}
            elif kind == "cancel":
                resp = {"ok": self.cancel_job(str(msg.get("job")))}
            elif kind == "shutdown":
                resp = {"ok": True}
            else:
                resp = {"ok": False, "error": f"unknown request {kind!r}"}
            send_msg(sock, resp)
            if kind == "shutdown":
                threading.Thread(target=self.shutdown,
                                 daemon=True).start()
        except WireError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass
