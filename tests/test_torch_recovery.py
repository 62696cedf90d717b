"""Executor fault recovery in the port (twins of
``tests/test_executor_recovery.py``): scripted step faults, bounded-
backoff retry of transients, fatal member drop, async checkpointing, and
the acceptance identity: restart from a checkpoint replays the remaining
steps bit-exactly. On reduced f32 configs on the CPU.

Each test drives the port's executor and the reference's side by side
(:class:`Twin`): the same specs, the same fault script and the same
weights (the reference's ``init_params(cfg, PRNGKey(seed))``, carried
into the port by ``params_from_numpy``). Every call's outcome, the
executors' counters and the runs' reports must agree exactly, losses to
1e-5 relative. The port's bitwise identities (restart == uninterrupted
run, survivor == solo run) are checked inside the port as well.

The reference's ``test_shared_program_cache_across_executors`` has no
twin: the port runs eagerly and has no compiled programs to cache."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.npz import _flatten as ref_flatten
from repro.configs import get_config as ref_get_config
from repro.launch import cluster as ref_cluster
from repro.models import init_params as ref_init_params
from repro.util.retry import RetryPolicy as RefRetryPolicy
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import cluster
from repro_torch.launch.cluster import (FatalFault, FaultSpec, JobSpec,
                                        ScheduleExecutor, ScriptedFaults,
                                        TransientFault)
from repro_torch.tree import flatten
from repro_torch.util.retry import RetryPolicy
from _torch_threads import one_torch_thread  # noqa: F401

# losses to 1e-5 relative in f32; in bf16 to half the format's epsilon
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -9}
_REF_PROGRAMS = {}      # the reference compiles each group once per file
_REF_WEIGHTS = {}


def _cfgs(name, dtype):
    return (dataclasses.replace(get_config(name).reduced(), dtype=dtype),
            dataclasses.replace(ref_get_config(name).reduced(),
                                dtype=dtype))


def _spec(name="minicpm-2b", batch=2, seq=32, dtype="float32", **kw):
    return JobSpec(_cfgs(name, dtype)[0], batch=batch, seq=seq, **kw)


def _ref_spec(name="minicpm-2b", batch=2, seq=32, dtype="float32", **kw):
    return ref_cluster.JobSpec(_cfgs(name, dtype)[1], batch=batch, seq=seq,
                               **kw)


@pytest.fixture(autouse=True)
def reference_weights(monkeypatch):
    """Every state the port's executor builds (``start``, ``restart``)
    starts from the reference's weights for the job's seed."""
    def init(cfg, seed, device=None):
        key = (cfg.name, cfg.dtype, seed)
        if key not in _REF_WEIGHTS:
            name = cfg.name.removesuffix("-reduced")
            _REF_WEIGHTS[key] = ref_flatten(ref_init_params(
                _cfgs(name, cfg.dtype)[1], jax.random.PRNGKey(seed)))
        return params_from_numpy(_REF_WEIGHTS[key], device=device)
    monkeypatch.setattr(cluster, "init_params", init)


def _leaves_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    return sorted(fa) == sorted(fb) and all(
        torch.equal(fa[k], fb[k]) for k in fa)


def _opt_equal(a, b):
    return a.step == b.step and _leaves_equal(a.m, b.m) and \
        _leaves_equal(a.v, b.v)


def _ex(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("sleep", lambda d: None)   # no wall-clock in tests
    return ScheduleExecutor(**kw)


def _base(spec, steps):
    base = _ex()
    base.submit("a", spec, steps)
    base.start("a")
    for _ in range(steps):
        base.step_group(["a"])
    return base.runs["a"]


def _same_report(got, want, rtol):
    """A run's report against the reference's: every key, the loss to
    ``rtol``, the walltime only as zero or not (it is measured)."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key == "loss":
            np.testing.assert_allclose(got[key], w, rtol=rtol)
        elif key == "walltime":
            assert (got[key] > 0.0) == (w > 0.0), key
        else:
            assert got[key] == w, key


class Twin:
    """The port's executor and the reference's, under the same fault
    script, retry policy and checkpoint settings. Each method applies one
    operation to both and compares what comes back."""

    RUN_FIELDS = ("steps_done", "started", "finished", "failed",
                  "restarts", "retries", "last_ckpt_step", "sub_batch",
                  "accum_steps")
    COUNTERS = ("calls", "drops_total", "retries_total",
                "checkpoints_written")

    def __init__(self, script=(), *, tmp_path=None, policy=None, **kw):
        def faults(cls, spec_cls):
            return cls([spec_cls(call=c, job=j, kind=k, times=t)
                        for c, j, k, t in script])

        def common(sub):
            out = dict(kw, sleep=lambda d: None)
            if tmp_path is not None:
                out["checkpoint_dir"] = str(tmp_path / sub)
            return out

        self.port = _ex(
            fault_injector=faults(ScriptedFaults, FaultSpec),
            retry_policy=RetryPolicy(**policy) if policy else None,
            **common("port"))
        self.ref = ref_cluster.ScheduleExecutor(
            donate=True, program_cache=_REF_PROGRAMS,
            fault_injector=faults(ref_cluster.ScriptedFaults,
                                  ref_cluster.FaultSpec),
            retry_policy=RefRetryPolicy(**policy) if policy else None,
            **common("ref"))
        self.rtol = {}

    def submit(self, job, steps, **spec_kw):
        self.rtol[job] = LOSS_RTOL[spec_kw.get("dtype", "float32")]
        self.port.submit(job, _spec(**spec_kw), steps)
        self.ref.submit(job, _ref_spec(**spec_kw), steps)

    def start(self, name):
        self.port.start(name)
        self.ref.start(name)

    def step(self, names):
        got = self.port.step_group(names)
        want = self.ref.step_group(names)
        assert sorted(got) == sorted(want)
        assert got.get("dropped") == want.get("dropped")
        assert sorted(got["losses"]) == sorted(want["losses"])
        for n, loss in want["losses"].items():
            np.testing.assert_allclose(got["losses"][n], loss,
                                       rtol=self.rtol[n])
        assert (got["walltime"] > 0.0) == (want["walltime"] > 0.0)
        return got

    def restart(self, name):
        run = self.port.restart(name)
        self.ref.restart(name)
        return run

    def execute(self, phases):
        got = self.port.execute(phases(cluster))
        want = self.ref.execute(phases(ref_cluster))
        assert sorted(got) == sorted(want)
        for n in want:
            _same_report(got[n], want[n], self.rtol[n])
        return got

    def check(self):
        """Flush both writers, then compare every counter and run."""
        self.port.flush_checkpoints()
        self.ref.flush_checkpoints()
        for attr in self.COUNTERS:
            assert getattr(self.port, attr) == getattr(self.ref, attr), attr
        assert sorted(self.port.runs) == sorted(self.ref.runs)
        for n, want in self.ref.runs.items():
            got = self.port.runs[n]
            for attr in self.RUN_FIELDS:
                assert getattr(got, attr) == getattr(want, attr), (n, attr)
            _same_report(got.report(), want.report(), self.rtol[n])

    def close(self):
        self.port.close()
        self.ref.close()


# ===================================================================== #
# Scripted fault injector
# ===================================================================== #
class TestScriptedFaults:
    def test_spec_validation(self):
        for cls in (FaultSpec, ref_cluster.FaultSpec):
            with pytest.raises(ValueError, match="unknown fault kind"):
                cls(call=0, job="a", kind="weird")

    def test_fires_only_on_matching_call_and_member(self):
        inj = ScriptedFaults([FaultSpec(call=2, job="a")])
        inj.check(0, ("a",))
        inj.check(2, ("b",))        # wrong member: silent
        with pytest.raises(TransientFault):
            inj.check(2, ("a", "b"))
        inj.check(2, ("a",))        # times=1 budget consumed

    def test_times_budget_and_fatal_kind(self):
        inj = ScriptedFaults([FaultSpec(call=1, job="a", times=2),
                              FaultSpec(call=5, job="b", kind="fatal")])
        for _ in range(2):
            with pytest.raises(TransientFault):
                inj.check(1, ("a",))
        inj.check(1, ("a",))
        with pytest.raises(FatalFault) as ei:
            inj.check(5, ("b",))
        assert ei.value.job == "b"

    def test_fires_as_the_reference_does(self):
        """One script, one sequence of checks: the same faults, in the
        same places, from both injectors."""
        script = [(1, "a", "transient", 2), (1, "b", "fatal", 1),
                  (3, "b", "transient", 1), (4, "a", "fatal", 2)]
        checks = [(c, names) for c in range(6)
                  for names in (("a",), ("b",), ("a", "b"))] * 2

        def trace(faults_cls, spec_cls):
            inj = faults_cls([spec_cls(call=c, job=j, kind=k, times=t)
                              for c, j, k, t in script])
            out = []
            for call, names in checks:
                try:
                    inj.check(call, names)
                    out.append(None)
                except RuntimeError as e:
                    out.append((type(e).__name__, e.job, str(e)))
            return out

        got = trace(ScriptedFaults, FaultSpec)
        assert got == trace(ref_cluster.ScriptedFaults,
                            ref_cluster.FaultSpec)
        assert sum(x is not None for x in got) == 6


# ===================================================================== #
# Retry / degrade inside step_group
# ===================================================================== #
class TestStepGroupFaults:
    def test_transient_absorbed_by_retry(self):
        tw = Twin([(1, "a", "transient", 2)],
                  policy=dict(attempts=3, base=0.0))
        tw.submit("a", 3)
        tw.start("a")
        for _ in range(3):
            assert "dropped" not in tw.step(["a"])
        tw.check()
        ex = tw.port
        assert ex.runs["a"].steps_done == 3
        assert ex.runs["a"].retries == 2
        assert ex.retries_total == 2
        assert ex.drops_total == 0
        # a retried call replays the step it would have taken
        base = _base(_spec(), 3)
        assert _leaves_equal(ex.runs["a"].params, base.params)
        assert _opt_equal(ex.runs["a"].opt, base.opt)

    def test_exhausted_transient_escalates_to_drop(self):
        tw = Twin([(1, "a", "transient", 3)],
                  policy=dict(attempts=3, base=0.0))
        tw.submit("a", 3)
        tw.start("a")
        tw.step(["a"])
        assert tw.step(["a"])["dropped"] == "a"
        tw.check()
        ex = tw.port
        assert ex.runs["a"].failed
        assert ex.runs["a"].steps_done == 1
        assert ex.drops_total == 1
        for side in (tw.port, tw.ref):
            with pytest.raises(RuntimeError, match="not running"):
                side.step_group(["a"])    # failed members cannot step

    def test_fatal_fault_in_group_drops_only_the_victim(self):
        """The survivor's state after the drop equals a solo run of the
        same step count."""
        tw = Twin([(2, "b", "fatal", 1)])
        tw.submit("a", 4)
        tw.submit("b", 4, seed=3)
        tw.start("a")
        tw.start("b")
        for _ in range(2):
            assert "dropped" not in tw.step(["a", "b"])
        assert tw.step(["a", "b"])["dropped"] == "b"
        for _ in range(2):
            assert "dropped" not in tw.step(["a"])
        tw.check()
        ex = tw.port
        assert ex.runs["a"].steps_done == 4
        assert ex.runs["b"].steps_done == 2 and ex.runs["b"].failed
        assert ex.calls == 4                # the dropped call is not one
        solo = _base(_spec(), 4)
        assert _leaves_equal(ex.runs["a"].params, solo.params)


# ===================================================================== #
# Checkpoint / restart
# ===================================================================== #
class TestCheckpointRestart:
    @pytest.mark.parametrize("name,dtype", [
        ("minicpm-2b", "float32"), ("qwen2-vl-2b", "float32"),
        ("minicpm-2b", "bfloat16")])
    def test_restart_from_checkpoint_bit_exact(self, tmp_path, name, dtype):
        """The acceptance identity: fail at step 4 (checkpoint at 4),
        restart, run to 6: params, opt state and loss bit-identical to
        an uninterrupted 6-step run (bf16 params go through the file as
        their raw bits). The reference cannot reload its own bf16 file
        (its loader hashes the stored raw type, not "bfloat16"), so at
        bf16 the twin stops at the drop and the port restarts alone."""
        spec = _spec(name, dtype=dtype)
        base = _base(spec, 6)

        tw = Twin([(4, "a", "fatal", 1)], tmp_path=tmp_path,
                  checkpoint_every=2)
        tw.submit("a", 6, name=name, dtype=dtype)
        tw.start("a")
        for _ in range(4):
            assert "dropped" not in tw.step(["a"])
        assert tw.step(["a"])["dropped"] == "a"
        tw.check()
        ex = tw.port
        assert ex.runs["a"].failed
        assert ex.runs["a"].last_ckpt_step == 4
        assert ex.checkpoints_written == 2  # steps 2 and 4 landed

        if dtype == "float32":
            run = tw.restart("a")
            tw.check()
        else:
            run = ex.restart("a")
        assert not run.failed and run.restarts == 1
        assert run.steps_done == 4          # resumed at the checkpoint
        assert run.opt.step == 4 and isinstance(run.opt.step, int)
        while run.steps_done < 6:
            if dtype == "float32":
                assert "dropped" not in tw.step(["a"])
            else:
                assert "dropped" not in ex.step_group(["a"])
        if dtype == "float32":
            tw.check()
        tw.close()
        assert _leaves_equal(run.params, base.params)
        assert _opt_equal(run.opt, base.opt)
        assert torch.equal(run.last_metrics["loss"],
                           base.last_metrics["loss"])
        assert run.report()["restarts"] == 1

    def test_restart_without_checkpoint_starts_from_scratch(self, tmp_path):
        tw = Twin([(1, "a", "fatal", 1)], tmp_path=tmp_path,
                  checkpoint_every=0)
        tw.submit("a", 4)
        tw.start("a")
        tw.step(["a"])
        assert tw.step(["a"])["dropped"] == "a"
        run = tw.restart("a")
        tw.check()
        assert run.steps_done == 0 and run.restarts == 1
        assert run.opt.step == 0
        # the state is the job's fresh one, rebuilt from its seed
        fresh = _ex()
        fresh.submit("a", _spec(), 1)
        fresh.start("a")
        assert _leaves_equal(run.params, fresh.runs["a"].params)
        # and it trains on as the reference's fresh state does
        tw.step(["a"])
        tw.check()

    def test_checkpoint_requires_dir_and_started_run(self, tmp_path):
        tw = Twin()
        tw.submit("a", 2)
        tw.start("a")
        for side in (tw.port, tw.ref):
            with pytest.raises(RuntimeError, match="no checkpoint_dir"):
                side.checkpoint("a")
        tw2 = Twin(tmp_path=tmp_path)
        tw2.submit("a", 2)
        for side in (tw2.port, tw2.ref):
            with pytest.raises(RuntimeError, match="not started"):
                side.checkpoint("a")
            with pytest.raises(RuntimeError, match="not started"):
                side.restart("a")

    def test_snapshot_is_taken_at_checkpoint_time(self, tmp_path):
        """The host copy is made before checkpoint() returns: steps
        taken while the write is queued do not leak into the file. The
        two packages' files hold the same keys, dtypes, shapes and step.
        Their values are not compared: AdamW's first update divides each
        gradient by its own magnitude, so a last-bit difference in a
        near-zero gradient becomes a difference of the update's size."""
        tw = Twin(tmp_path=tmp_path)
        tw.submit("a", 3)
        tw.start("a")
        tw.step(["a"])
        tw.port.checkpoint("a")
        tw.ref.checkpoint("a")
        tw.step(["a"])
        tw.step(["a"])
        tw.close()
        tw.check()
        with np.load(tmp_path / "port" / "a.npz") as got, \
                np.load(tmp_path / "ref" / "a.npz") as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                assert got[key].dtype == want[key].dtype, key
                assert got[key].shape == want[key].shape, key
            for key in ("step", "opt/.step"):
                assert int(got[key]) == int(want[key]) == 1
        base = _base(_spec(), 1)
        ex2 = _ex()
        ex2.submit("a", _spec(), 3)
        ex2.start("a")
        run = ex2.restore_run("a", str(tmp_path / "port" / "a.npz"))
        assert run.steps_done == 1
        assert _leaves_equal(run.params, base.params)
        assert _opt_equal(run.opt, base.opt)

    def test_background_write_error_surfaces_at_flush(self, tmp_path):
        for sub in ("port", "ref"):
            (tmp_path / sub).write_text("not a directory")
        tw = Twin(tmp_path=tmp_path)
        tw.submit("a", 2)
        tw.start("a")
        for side in (tw.port, tw.ref):
            side.checkpoint("a")    # enqueue succeeds; the write fails
            with pytest.raises(OSError):
                side.flush_checkpoints()
            assert side.checkpoints_written == 0

    def test_close_drains_and_joins_writer_thread(self, tmp_path):
        tw = Twin(tmp_path=tmp_path, checkpoint_every=1)
        tw.submit("a", 2)
        tw.start("a")
        tw.step(["a"])
        tw.step(["a"])
        threads = [tw.port._ckpt_thread, tw.ref._ckpt_thread]
        assert all(t is not None and t.is_alive() for t in threads)
        tw.close()
        assert not any(t.is_alive() for t in threads)
        tw.check()
        assert tw.port.checkpoints_written == 2
        assert len(tw.port.checkpoint_seconds) == 2
        for sub in ("port", "ref"):
            assert (tmp_path / sub / "a.npz").exists()
        tw.close()                       # idempotent
        with _ex(checkpoint_dir=str(tmp_path / "port")) as ex2:
            ex2.submit("a", _spec(), 1)
            ex2.start("a")
            ex2.checkpoint("a")
            t2 = ex2._ckpt_thread
        assert not t2.is_alive()         # __exit__ closed it

    def test_host_snapshots_are_bounded(self, tmp_path, monkeypatch):
        """With the writer held on its first file, one more snapshot
        queues and the next ``checkpoint()`` waits: no more than
        ``CKPT_SNAPSHOTS`` host copies of the state exist at once."""
        import threading
        release = threading.Event()
        save = cluster._ckpt.save_pytree

        def held(path, tree):
            release.wait()
            save(path, tree)
        monkeypatch.setattr(cluster._ckpt, "save_pytree", held)
        ex = _ex(checkpoint_dir=str(tmp_path))
        ex.submit("a", _spec(), 1)
        ex.start("a")
        assert ex.CKPT_SNAPSHOTS == 2
        for _ in range(ex.CKPT_SNAPSHOTS):
            ex.checkpoint("a")
        third = threading.Thread(target=ex.checkpoint, args=("a",))
        third.start()
        third.join(0.5)
        assert third.is_alive()          # waiting for the writer
        release.set()
        third.join()
        ex.close()
        assert ex.checkpoints_written == 3

    def test_close_surfaces_background_write_error(self, tmp_path):
        for sub in ("port", "ref"):
            (tmp_path / sub).write_text("not a directory")
        tw = Twin(tmp_path=tmp_path)
        tw.submit("a", 2)
        tw.start("a")
        for side in (tw.port, tw.ref):
            side.checkpoint("a")
            with pytest.raises(OSError):
                side.close()

    def test_checkpoint_tag_names_epoch_files(self, tmp_path):
        tw = Twin(tmp_path=tmp_path, checkpoint_tag=".e0003")
        tw.submit("a", 1)
        tw.start("a")
        tw.step(["a"])
        tw.port.checkpoint("a")
        tw.ref.checkpoint("a")
        tw.close()
        tw.check()
        for sub in ("port", "ref"):
            assert sorted(p.name for p in (tmp_path / sub).iterdir()) == [
                "a.e0003.npz"]

    def test_restore_run_from_explicit_path(self, tmp_path):
        """restore_run loads a named epoch file bit-exactly: resume from
        it and match an uninterrupted run."""
        spec = _spec()
        base = _base(spec, 4)

        tw = Twin(tmp_path=tmp_path, checkpoint_tag=".e0001")
        tw.submit("a", 4)
        tw.start("a")
        tw.step(["a"])
        tw.step(["a"])
        tw.port.checkpoint("a")
        tw.ref.checkpoint("a")
        tw.close()

        tw2 = Twin()
        tw2.submit("a", 4)
        tw2.start("a")
        table = tw2.port.runs["a"].params["embed"]["table"]
        run = tw2.port.restore_run(
            "a", str(tmp_path / "port" / "a.e0001.npz"))
        tw2.ref.restore_run("a", str(tmp_path / "ref" / "a.e0001.npz"))
        tw2.check()
        assert run.steps_done == 2 and run.last_ckpt_step == 2
        assert run.params["embed"]["table"] is table   # in place
        tw2.step(["a"])
        tw2.step(["a"])
        tw2.check()
        assert _leaves_equal(run.params, base.params)
        assert _opt_equal(run.opt, base.opt)


# ===================================================================== #
# Degraded-mode plan execution
# ===================================================================== #
class TestExecuteDegraded:
    def test_failed_member_drops_and_survivors_finish(self):
        tw = Twin([(2, "b", "fatal", 1)])
        tw.submit("a", 4)
        tw.submit("b", 4, seed=3)

        def plan(mod):
            return [mod.PlanPhase(
                ops=(mod.PlanOp("start", "a"), mod.PlanOp("start", "b")),
                quotas=(("a", 4), ("b", 4)),
                groups=(("a", "b"),))]
        report = tw.execute(plan)
        tw.check()
        assert report["a"]["steps"] == 4 and not report["a"]["failed"]
        assert report["b"]["steps"] == 2 and report["b"]["failed"]
        assert report["b"]["restarts"] == 0
        assert tw.port.drops_total == 1
        # walltime is attributed to survivors only
        assert report["a"]["walltime"] > 0.0
        assert report["b"]["walltime"] == 0.0
        # the survivor trained as it would have alone
        assert _leaves_equal(tw.port.runs["a"].params,
                             _base(_spec(), 4).params)
