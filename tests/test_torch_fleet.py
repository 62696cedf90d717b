"""The port's master/agent fleet against the reference's
(``tests/test_fleet.py`` on the CPU): the wire protocol, the heartbeat
suspect/dead state machine and lease-epoch fencing against fake agents,
the CLI's client path, and real two-agent runs of the 4-job replay
schedule on reduced f32 configs: every job's steps, loss and checkpoint
CRC equal to the port's single-host executor's, with and without a
SIGKILLed agent. Cross-package: ``spec_to_wire`` gives the reference's
JSON byte for byte for all ten architectures, each package's
``MessageReader`` reads the other's frames, and the port's simulator copy
gives the reference's replay plan."""
import dataclasses
import json
import os
import socket
import time

import pytest
import torch

import repro.launch.wire as ref_wire
from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.launch.cluster import JobSpec as RefJobSpec
from repro_torch.checkpoint import checkpoint_crc
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import (ClusterState, InterferenceModel, Job,
                              PerfParams, Simulator)
from repro_torch.core.schedulers import SJF_BSBF
from repro_torch.kernels import autotune
from repro_torch.launch.agent import AgentRuntime
from repro_torch.launch.cluster import (JobSpec, ScheduleExecutor,
                                        plan_from_sim)
from repro_torch.launch.fleet import (ChaosKiller, FleetConfig, FleetError,
                                      FleetMaster, KillSpec, MasterJob)
from repro_torch.launch.wire import (MessageReader, WireError, send_msg,
                                     spec_from_wire, spec_to_wire)
from repro_torch.util.retry import RetryBudgetExceeded, RetryPolicy
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.timeout(900)


def _spec(name="minicpm-2b", batch=2, seq=32, **kw):
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    return JobSpec(cfg, batch=batch, seq=seq, **kw)


# ===================================================================== #
# Wire protocol
# ===================================================================== #
class TestWire:
    def test_spec_roundtrip_through_json(self):
        spec = _spec("qwen2-vl-2b", batch=4, seed=7, accum_steps=2)
        wire = json.loads(json.dumps(spec_to_wire(spec)))
        back = spec_from_wire(wire)
        assert back == spec          # tuple fields survive the list form
        assert isinstance(back.cfg.mrope_sections, tuple)

    def test_framing_eof_and_bad_frame(self):
        a, b = socket.socketpair()
        try:
            send_msg(a, {"x": 1})
            send_msg(a, {"y": [1, 2]})
            reader = MessageReader(b)
            assert reader.read() == {"x": 1}
            assert reader.read() == {"y": [1, 2]}
            a.sendall(b"not json\n")
            with pytest.raises(WireError, match="bad frame"):
                reader.read()
            a.close()
            assert reader.read() is None    # EOF, never a hang
        finally:
            b.close()

    def test_send_to_closed_socket_raises_wire_error(self):
        a, b = socket.socketpair()
        b.close()
        a.close()
        with pytest.raises(WireError):
            send_msg(a, {"x": 1})


class TestWireAgainstReference:
    def test_all_ten_architectures_are_ported(self):
        assert tuple(ARCH_NAMES) == tuple(REF_ARCH_NAMES)
        assert len(ARCH_NAMES) == 10

    @pytest.mark.parametrize("arch", sorted(ARCH_NAMES))
    @pytest.mark.parametrize("reduced", [False, True])
    def test_spec_to_wire_is_the_references_json(self, arch, reduced):
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        if reduced:
            cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
        kw = dict(batch=4, accum_steps=2, seq=64, seed=3)
        ours = spec_to_wire(JobSpec(cfg, **kw))
        theirs = ref_wire.spec_to_wire(RefJobSpec(ref_cfg, **kw))
        assert json.dumps(ours) == json.dumps(theirs)
        assert (json.dumps(ours, separators=(",", ":")).encode()
                == json.dumps(theirs, separators=(",", ":")).encode())
        # each package rebuilds the other's spec
        assert spec_from_wire(json.loads(json.dumps(theirs))) \
            == JobSpec(cfg, **kw)
        assert ref_wire.spec_from_wire(json.loads(json.dumps(ours))) \
            == RefJobSpec(ref_cfg, **kw)

    @pytest.mark.parametrize("sender,reader", [
        (send_msg, ref_wire.MessageReader),
        (ref_wire.send_msg, MessageReader)])
    def test_frames_cross_between_packages(self, sender, reader):
        msg = {"type": "lease", "lease_id": 3, "epoch": 7,
               "members": [{"name": "A", "spec": spec_to_wire(_spec()),
                            "restore_epochs": [1, 2]}]}
        a, b = socket.socketpair()
        try:
            sender(a, msg)
            sender(a, {"type": "heartbeat", "watermark": {"A": 2}})
            r = reader(b)
            assert r.read() == json.loads(json.dumps(msg))  # tuples: lists
            assert r.read() == {"type": "heartbeat", "watermark": {"A": 2}}
            a.close()
            assert r.read() is None
        finally:
            b.close()


# ===================================================================== #
# Fake-agent harness: state machine + fencing without subprocesses
# ===================================================================== #
class FakeAgent:
    """A hand-driven agent connection: the tests decide exactly when it
    heartbeats, replies, or goes silent."""

    def __init__(self, port, agent_id):
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.sock.settimeout(5.0)
        self.reader = MessageReader(self.sock)
        self.id = agent_id
        send_msg(self.sock, {"type": "hello", "role": "agent",
                             "id": agent_id, "pid": None})

    def heartbeat(self, watermark=None, epoch=None):
        send_msg(self.sock, {"type": "heartbeat", "agent": self.id,
                             "watermark": watermark or {}, "epoch": epoch})

    def send(self, msg):
        send_msg(self.sock, msg)

    def recv(self):
        return self.reader.read()

    def close(self):
        self.sock.close()


def _wait(predicate, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.01)


def _fast_cfg(**kw):
    kw.setdefault("heartbeat_interval", 0.05)
    kw.setdefault("suspect_after", 0.15)
    kw.setdefault("dead_after", 0.4)
    kw.setdefault("retry_policy",
                  RetryPolicy(attempts=3, base=0.01, deadline=5.0))
    kw.setdefault("device", "cpu")
    return FleetConfig(**kw)


class TestStateMachine:
    def test_missed_heartbeats_suspect_then_dead(self, tmp_path):
        with FleetMaster(str(tmp_path), config=_fast_cfg()) as m:
            m.start(0)
            fa = FakeAgent(m.port, "f0")
            _wait(lambda: m.agents.get("f0", None) is not None
                  and m.agents["f0"].state == "alive", msg="agent up")
            # silence (no close: the socket stays open, like a hung host)
            _wait(lambda: m.agents["f0"].state == "dead", timeout=5.0,
                  msg="dead declaration")
            kinds = [e["kind"] for e in m.events]
            assert "agent_suspect" in kinds and "agent_dead" in kinds
            dead = next(e for e in m.events if e["kind"] == "agent_dead")
            assert dead["reason"] == "heartbeat"
            assert 0.0 <= dead["detection_latency"] < 5.0
            fa.close()

    def test_heartbeat_recovers_suspect_agent(self, tmp_path):
        cfg = _fast_cfg(suspect_after=0.1, dead_after=10.0)
        with FleetMaster(str(tmp_path), config=cfg) as m:
            m.start(0)
            fa = FakeAgent(m.port, "f0")
            _wait(lambda: "f0" in m.agents
                  and m.agents["f0"].state == "alive", msg="agent up")
            _wait(lambda: m.agents["f0"].state == "suspect",
                  msg="suspect")
            fa.heartbeat()
            _wait(lambda: m.agents["f0"].state == "alive",
                  msg="recovery")
            assert any(e["kind"] == "agent_recovered" for e in m.events)
            fa.close()

    def test_watermark_regression_is_counted(self, tmp_path):
        with FleetMaster(str(tmp_path),
                         config=_fast_cfg(dead_after=10.0)) as m:
            m.start(0)
            fa = FakeAgent(m.port, "f0")
            _wait(lambda: "f0" in m.agents
                  and m.agents["f0"].state == "alive", msg="agent up")
            fa.heartbeat({"j": 3})
            _wait(lambda: m.agents["f0"].watermark.get("j") == 3,
                  msg="watermark")
            fa.heartbeat({"j": 1})      # progress must be monotone
            _wait(lambda: m.stats["watermark_regressions"] == 1,
                  msg="regression count")
            fa.close()

    def test_agent_spawn_command_names_the_port(self, tmp_path,
                                                monkeypatch):
        """``spawn_agent`` runs the port's agent module on the configured
        device, a CPU agent at this process's thread count, with the
        port's source root on the path (no process is started here)."""
        import subprocess

        import repro_torch
        seen = {}

        class Proc:
            pid = None

            def __init__(self, cmd, env=None, **kw):
                seen.update(cmd=cmd, env=env)

            def poll(self):
                return 0

        monkeypatch.setattr(subprocess, "Popen", Proc)
        m = FleetMaster(str(tmp_path), config=_fast_cfg())
        m.port = 4242
        assert m.spawn_agent() == "a0"
        cmd = seen["cmd"]
        assert cmd[1:3] == ["-m", "repro_torch.launch.agent"]
        assert cmd[cmd.index("--port") + 1] == "4242"
        assert cmd[cmd.index("--device") + 1] == "cpu"
        assert cmd[cmd.index("--threads") + 1] == str(torch.get_num_threads())
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == src
        assert FleetConfig().device is None        # the card by default


class TestTableGoesWithTheLease:
    """Master and agents route alike: each lease carries the table
    installed in the master's process (or none), and the agent installs
    it before it steps."""

    PAYLOAD = {"version": autotune.AUTOTUNE_VERSION, "created": 0.0,
               "meta": {"backend": "cuda", "device_name": "card"},
               "entries": {"flash_decode|s4096|d64|bfloat16": {
                   "backend": "kernel", "split": 512}}}

    def test_lease_carries_the_masters_table(self, tmp_path):
        try:
            with FleetMaster(str(tmp_path), config=_fast_cfg()) as m:
                m.start(0)
                fa = FakeAgent(m.port, "f0")
                _wait(lambda: "f0" in m.agents
                      and m.agents["f0"].state == "alive", msg="agent up")
                leases = []
                for name, table in (("none", None), ("tuned", self.PAYLOAD)):
                    autotune.set_table(None if table is None
                                       else autotune.AutotuneTable(table))
                    m.submit_job({"stub": True}, steps=1, name=name)
                    lease = fa.recv()
                    leases.append(lease["autotune"])
                    fa.send({"type": "lease_done",
                             "lease_id": lease["lease_id"],
                             "epoch": lease["epoch"], "walltime": 0.1,
                             "report": {name: {"steps": 1,
                                               "resumed_from": 0}}})
                    m.wait_for_job(name, timeout=5.0)
                assert leases == [None, self.PAYLOAD]
                fa.close()
        finally:
            autotune.set_table(None)

    @pytest.mark.parametrize("table", [None, PAYLOAD])
    def test_agent_installs_the_leases_table(self, tmp_path, table):
        a, b = socket.socketpair()
        try:
            autotune.set_table(autotune.AutotuneTable(self.PAYLOAD)
                               if table is None else None)
            agent = AgentRuntime(a, "a0", device="cpu")
            agent._execute_lease({"lease_id": 1, "epoch": 1,
                                  "ckpt_dir": str(tmp_path), "members": [],
                                  "autotune": table})
            got = autotune.get_table()
            assert (None if got is None else got.payload) == table
        finally:
            autotune.set_table(None)
            a.close()
            b.close()


class TestFencing:
    def test_zombie_lease_is_fenced_and_job_requeued(self, tmp_path):
        """An agent takes a lease, goes silent past the timeout
        (unconfirmed death -> its epoch is fenced), then wakes up and
        reports completion: the stale result is discarded, and the job
        re-runs on a second agent whose lease excludes the fenced epoch
        from restore_epochs."""
        with FleetMaster(str(tmp_path), config=_fast_cfg()) as m:
            m.start(0)
            fa = FakeAgent(m.port, "f0")
            _wait(lambda: "f0" in m.agents
                  and m.agents["f0"].state == "alive", msg="agent up")
            m.submit_job({"stub": True}, steps=5, name="j")
            lease = fa.recv()
            assert lease["type"] == "lease"
            assert lease["members"][0]["name"] == "j"
            epoch = lease["epoch"]
            fa.heartbeat({"j": 2}, epoch=epoch)
            # now go silent until declared dead
            _wait(lambda: m.agents["f0"].state == "dead", timeout=5.0,
                  msg="dead declaration")
            assert epoch in m._fenced_epochs
            # zombie resumes and reports a full run: must be discarded
            fenced_before = m.stats["fenced"]
            fa.send({"type": "lease_done", "lease_id": lease["lease_id"],
                     "epoch": epoch, "walltime": 1.0,
                     "report": {"j": {"steps": 5, "resumed_from": 0}}})
            _wait(lambda: m.stats["fenced"] > fenced_before,
                  msg="fenced result")
            assert not m.jobs["j"].finished
            # a fresh agent picks up the requeued job
            fb = FakeAgent(m.port, "f1")
            lease2 = fb.recv()
            assert lease2["type"] == "lease"
            assert lease2["epoch"] != epoch
            assert epoch not in lease2["members"][0]["restore_epochs"]
            fb.heartbeat({"j": 5}, epoch=lease2["epoch"])
            fb.send({"type": "lease_done",
                     "lease_id": lease2["lease_id"],
                     "epoch": lease2["epoch"], "walltime": 2.0,
                     "report": {"j": {"steps": 5, "resumed_from": 0,
                                      "loss": 1.5}}})
            rep = m.wait_for_job("j", timeout=5.0)
            assert rep["finished"] and rep["steps"] == 5
            assert m.jobs["j"].redispatches == 1
            fa.close()
            fb.close()

    def test_cancel_requeued_before_dispatch(self, tmp_path):
        with FleetMaster(str(tmp_path), config=_fast_cfg()) as m:
            m.start(0)
            m.submit_job({"stub": True}, steps=5, name="j")
            assert m.cancel_job("j")
            assert not m.cancel_job("j")        # idempotent
            status = m.status()
            assert status["jobs"]["j"]["cancelled"]
            assert status["queue"] == []

    def test_dispatch_with_no_agents_exhausts_retry_budget(self, tmp_path):
        cfg = _fast_cfg(retry_policy=RetryPolicy(
            attempts=10, base=0.01, cap=0.02, deadline=0.2))
        with FleetMaster(str(tmp_path), config=cfg) as m:
            m.start(0)
            m.jobs["j"] = MasterJob(name="j", wire_spec={}, total_steps=1,
                                    started=True)
            with pytest.raises((RetryBudgetExceeded, FleetError)):
                m._dispatch(("j",), {"j": 1}, ("j",))


# ===================================================================== #
# CLI client path against an in-process master + fake agent
# ===================================================================== #
class TestFleetCLI:
    def test_submit_status_cancel_roundtrip(self, tmp_path, capsys):
        from repro_torch.launch import fleet_cli
        with FleetMaster(str(tmp_path),
                         config=_fast_cfg(dead_after=10.0)) as m:
            m.start(0)
            fa = FakeAgent(m.port, "f0")
            _wait(lambda: "f0" in m.agents
                  and m.agents["f0"].state == "alive", msg="agent up")
            port = str(m.port)
            rc = fleet_cli.main([
                "submit", "--port", port, "--arch", "minicpm-2b",
                "--reduced", "--steps", "2", "--name", "cli-job"])
            assert rc == 0
            assert "submitted cli-job" in capsys.readouterr().out
            lease = fa.recv()
            assert lease["members"][0]["name"] == "cli-job"
            # the wire spec the CLI built reconstructs into a JobSpec
            spec = spec_from_wire(lease["members"][0]["spec"])
            assert spec.cfg.name == "minicpm-2b-reduced"
            fa.send({"type": "lease_done", "lease_id": lease["lease_id"],
                     "epoch": lease["epoch"], "walltime": 0.5,
                     "report": {"cli-job": {"steps": 2,
                                            "resumed_from": 0}}})
            m.wait_for_job("cli-job", timeout=5.0)
            assert fleet_cli.main(["status", "--port", port]) == 0
            out = capsys.readouterr().out
            assert "cli-job: 2/2 finished" in out
            assert fleet_cli.main(
                ["cancel", "--port", port, "cli-job"]) == 1
            assert fleet_cli.main(["queue", "--port", port]) == 0
            assert fleet_cli.main(["status", "--port", port,
                                   "--json"]) == 0
            status = json.loads(capsys.readouterr().out.split("\n}\n")[-2]
                                + "\n}")
            assert status["jobs"]["cli-job"]["finished"]
            fa.close()

    def test_reference_client_talks_to_the_ports_master(self, tmp_path):
        """The requests and replies are the reference's: its one-shot RPC
        submits to the port's master and reads its status."""
        with FleetMaster(str(tmp_path), config=_fast_cfg()) as m:
            m.start(0)
            resp = ref_wire.request("127.0.0.1", m.port, {
                "type": "submit", "spec": spec_to_wire(_spec()),
                "steps": 3, "name": "r", "sub_batch": None})
            assert resp == {"ok": True, "job": "r"}
            status = ref_wire.request("127.0.0.1", m.port,
                                      {"type": "status"})
            assert status["ok"] and status["queue"] == ["r"]
            assert status["jobs"]["r"]["total_steps"] == 3

    def test_shutdown_request_stops_the_master(self, tmp_path, capsys):
        from repro_torch.launch import fleet_cli
        m = FleetMaster(str(tmp_path), config=_fast_cfg())
        m.start(0)
        assert fleet_cli.main(["shutdown", "--port", str(m.port)]) == 0
        assert "shutdown requested" in capsys.readouterr().out
        _wait(lambda: m._closing, msg="master closing")

    def test_unreachable_master_exits_2(self, capsys):
        from repro_torch.launch import fleet_cli
        sock = socket.create_server(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()                      # nothing listens here now
        assert fleet_cli.main(["status", "--port", str(port)]) == 2


# ===================================================================== #
# Real 2-agent subprocess fleet: the 4-job replay-validation schedule
# ===================================================================== #
GB = 2 ** 30


def _perf(alpha=0.01, beta=0.01, core=None):
    return (core or PerfParams)(
        alpha_comp=alpha, beta_comp=beta, alpha_comm=0.0, beta_comm=0.0,
        msg_bytes=0.0, delta=2.0, mem_base=4.0 * GB,
        mem_per_sample=0.25 * GB, param_bytes=1e8, n_workers=1)


def _replay_sim(core):
    """The replay-validation schedule (the reference's
    ``test_schedule_executor._scenario``) at iters_a=6 in ``core`` (the
    port's simulator copy or the reference's): donor A spans both GPUs,
    B/C form the 3-way sharing group with donor reconfigs, D queues."""
    pa = _perf(core=core.PerfParams)
    pb = _perf(beta=0.008, core=core.PerfParams)
    t_a = pa.t_iter(4)
    jobs = [core.Job(jid=0, model="m0", arrival=0.0, gpus=2, iters=6.0,
                     batch=4, perf=pa),
            core.Job(jid=1, model="m1", arrival=2 * t_a, gpus=1, iters=3.0,
                     batch=4, perf=pb),
            core.Job(jid=2, model="m1", arrival=4 * t_a, gpus=1, iters=4.0,
                     batch=4, perf=pb),
            core.Job(jid=3, model="m0", arrival=6 * t_a, gpus=1, iters=3.0,
                     batch=4, perf=pa)]
    cap = pa.mem_bytes(2) + pb.mem_bytes(2) + 0.25 * 0.25 * GB
    interf = core.InterferenceModel()
    for a in ("m0", "m1"):
        for b in ("m0", "m1"):
            interf.set_pair(a, b, 1.3, 1.3)
    cluster = core.ClusterState(n_servers=1, gpus_per_server=2,
                                gpu_capacity_bytes=cap)
    sim = core.Simulator(cluster, jobs,
                         core.SJF_BSBF(donor_reconfig=True),
                         interference=interf, reconfig_on_release=True)
    sim.run()
    return sim, cap


class _PortCore:
    PerfParams, Job, InterferenceModel = PerfParams, Job, InterferenceModel
    ClusterState, Simulator, SJF_BSBF = ClusterState, Simulator, SJF_BSBF


NAMES = {0: "A", 1: "B", 2: "C", 3: "D"}


def _replay_plan():
    sim, cap = _replay_sim(_PortCore)
    plan = plan_from_sim(sim.log, sim.jobs, sim.interference, cap,
                         names=NAMES)
    assert max(len(g) for p in plan.phases for g in p.groups
               if p.groups) == 3
    specs = {"A": _spec(batch=4), "B": _spec(batch=4, seed=1),
             "C": _spec(batch=4, seed=2), "D": _spec(batch=4, seed=3)}
    return plan, specs


def test_replay_plan_is_the_references():
    """The port's simulator copy and ``plan_from_sim`` give the plan the
    reference's fleet test replays: the same phases, quotas and groups."""
    import repro.core as ref_core
    from repro.core.schedulers import SJF_BSBF as RefSJF_BSBF
    from repro.launch.cluster import plan_from_sim as ref_plan_from_sim

    class RefCore:
        PerfParams, Job = ref_core.PerfParams, ref_core.Job
        InterferenceModel = ref_core.InterferenceModel
        ClusterState, Simulator = ref_core.ClusterState, ref_core.Simulator
        SJF_BSBF = RefSJF_BSBF

    sim, cap = _replay_sim(RefCore)
    want = ref_plan_from_sim(sim.log, sim.jobs, sim.interference, cap,
                             names=NAMES)
    got, _ = _replay_plan()
    assert len(got.phases) == len(want.phases) == 8
    for g, w in zip(got.phases, want.phases):
        assert [dataclasses.astuple(o) for o in g.ops] \
            == [dataclasses.astuple(o) for o in w.ops]
        assert g.quotas == w.quotas and g.groups == w.groups
    assert sum(q for p in got.phases for _, q in p.quotas) == 16


@pytest.fixture(scope="module")
def replay_reference(tmp_path_factory):
    """Single-host ScheduleExecutor run of the replay plan: the ground
    truth the fleet must match bit for bit (per-job final checkpoint
    CRCs, steps, losses). The executor releases a job's state when it
    finishes, so every step writes its checkpoint and a job's last file
    holds its final state."""
    plan, specs = _replay_plan()
    ref_dir = tmp_path_factory.mktemp("ref")
    totals = {}
    for phase in plan.phases:
        for name, q in phase.quotas:
            totals[name] = totals.get(name, 0) + q
    with ScheduleExecutor(device="cpu", checkpoint_dir=str(ref_dir),
                          checkpoint_every=1) as ex:
        for name, spec in specs.items():
            ex.submit(name, spec, totals[name])
        report = ex.execute(plan)
    crcs = {name: checkpoint_crc(os.path.join(str(ref_dir), f"{name}.npz"))
            for name in specs}
    assert all(c is not None for c in crcs.values())
    return {"plan": plan, "specs": specs, "report": report,
            "crcs": crcs}


def _fleet_cfg(**kw):
    # the agents take this process's one torch thread (the CPU's sums then
    # run in the same order); margins for a loaded CPU: a slow heartbeat
    # must not pass for a death
    return FleetConfig(checkpoint_every=1, device="cpu", **kw)


class TestTwoAgentFleet:
    def test_fleet_matches_single_host_bit_exactly(self, tmp_path,
                                                   replay_reference):
        """A 2-agent fleet run of the replay schedule gives the same
        per-job step counts, final losses, and checkpoint content CRCs as
        the single-host executor."""
        ref = replay_reference
        cfg = _fleet_cfg(suspect_after=2.0, dead_after=10.0)
        with FleetMaster(str(tmp_path), config=cfg) as m:
            m.start(n_agents=2)
            report = m.run_plan(ref["plan"], ref["specs"])
        for name in ref["specs"]:
            assert report[name]["finished"], name
            assert report[name]["steps"] == ref["report"][name]["steps"]
            assert report[name]["crc"] == ref["crcs"][name], \
                f"job {name}: fleet checkpoint diverged from single-host"
            assert report[name]["loss"] == ref["report"][name]["loss"]
        assert m.stats["redispatches"] == 0
        assert m.stats["fenced"] == 0
        assert {e["agent"] for e in m.events
                if e["kind"] == "lease_dispatch"} == {"a0", "a1"}

    def test_fleet_survives_sigkill_bit_exactly(self, tmp_path,
                                                replay_reference):
        """One agent is SIGKILLed mid-plan; the master detects it (its
        socket's EOF and the confirmed exit, well inside ``dead_after``),
        re-dispatches its group from the last checkpoint, and every job
        still matches the failure-free single-host run bit for bit."""
        ref = replay_reference
        cfg = _fleet_cfg(step_sleep=0.3, heartbeat_interval=0.1,
                         suspect_after=2.0, dead_after=5.0)
        chaos = ChaosKiller([KillSpec(agent="a0", after_steps=2)])
        with FleetMaster(str(tmp_path), config=cfg, chaos=chaos) as m:
            m.start(n_agents=2)
            report = m.run_plan(ref["plan"], ref["specs"])
            assert len(chaos.kills) == 1, "the scripted kill must fire"
            dead = [e for e in m.events if e["kind"] == "agent_dead"]
            assert dead and dead[0]["agent"] == "a0"
            assert dead[0]["killed"] and dead[0]["reason"] == "exit"
            assert dead[0]["detection_latency"] < cfg.dead_after + 1.0
            assert m.stats["redispatches"] >= 1
            assert [e["agent"] for e in dead] == ["a0"]
        for name in ref["specs"]:
            assert report[name]["finished"], name
            assert report[name]["steps"] == ref["report"][name]["steps"]
            assert report[name]["crc"] == ref["crcs"][name], \
                f"job {name}: recovery broke bit-exactness"
            assert report[name]["loss"] == ref["report"][name]["loss"]
