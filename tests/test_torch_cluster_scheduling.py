"""The two twins of the reference's examples, on the CPU:
``launch.cluster_scheduling`` prints the reference example's table, and
in its calibrated mode gives ``benchmarks/table2_physical.py``'s
calibrated results (all seven policies) on a small calibration
artifact; ``launch.shared_gpu_training`` measures a reduced pair and
takes Theorem 1's decision on it. No wall-clock assertion."""
import contextlib
import io
import json
import math
import runpy
import sys

import pytest

import repro.core as R
from benchmarks.common import run_all_policies as ref_run_all
from benchmarks.table2_physical import _calibrated_capacity
from repro_torch.core.pair import PairJob, best_pair_schedule
from repro_torch.launch import cluster_scheduling, shared_gpu_training


def _payload():
    """A calibration artifact with made-up, H100-plausible timings and
    memory (full-width bf16 jobs at B = 4)."""
    def arch(name, t4, t1, mem_base, mem_per_sample):
        beta = (t4 - t1) / 3
        return {"arch": name, "batch": 4, "seq": 2048, "accum_steps": 1,
                "sweep": {"sub_batches": [4, 2, 1],
                          "times": [t4, (t4 + t1) / 2, t1]},
                "alpha_comp": t1 - beta, "beta_comp": beta,
                "t_iter_solo": t4, "n_params": 10, "param_bytes": 40.0,
                "mem_base": mem_base, "mem_per_sample": mem_per_sample}

    def pair(a, b, ta, tb, t_pair):
        return {"a": a, "b": b, "t_a_solo": ta, "t_b_solo": tb,
                "t_pair": t_pair, "xi_a": t_pair / ta, "xi_b": t_pair / tb}
    a, b = "minicpm-2b", "qwen2-vl-2b"
    return {"version": 1, "host": {"backend": "cpu", "kind": "test"},
            "archs": {a: arch(a, 0.96, 0.36, 27.3e9, 6.1e9),
                      b: arch(b, 0.41, 0.29, 17.7e9, 3.9e9)},
            "pairs": {f"{a}+{b}": pair(a, b, 0.96, 0.41, 1.42),
                      f"{b}+{b}": pair(b, b, 0.41, 0.41, 0.83)}}


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue(), out


def test_cluster_scheduling_prints_the_examples_table(monkeypatch):
    example = runpy.run_path("examples/cluster_scheduling.py",
                             run_name="example")
    monkeypatch.setattr(sys, "argv", ["x", "--jobs", "30", "--seed", "1"])
    want, _ = _stdout(example["main"])
    got, results = _stdout(cluster_scheduling.main,
                           ["--jobs", "30", "--seed", "1"])
    assert got == want
    assert list(results) == list(cluster_scheduling.POLICIES)


def test_calibrated_mode_equals_table2_calibrated(tmp_path):
    path = tmp_path / "calibration_cuda.json"
    path.write_text(json.dumps(_payload()))
    text, results = _stdout(cluster_scheduling.main,
                            ["--calibrated", str(path)])
    cal = _payload()
    ref = ref_run_all(R.calibrated_trace(cal, n_jobs=30, seed=0, load=6.0),
                      n_servers=2, gpus_per_server=2,
                      interference=R.InterferenceModel.from_artifact(cal),
                      capacity_gb=_calibrated_capacity(cal) / 2 ** 30)
    assert cluster_scheduling.calibrated_capacity(cal) == \
        _calibrated_capacity(cal)
    assert list(results) == list(ref)
    for policy, r in results.items():
        assert r["res"].summary() == ref[policy].summary(), policy
        assert r["res"].events == ref[policy].events
        assert all(j.finish_time is not None for j in r["res"].jobs)
    assert "sharing beats exclusive" in text
    checks = cluster_scheduling.headline(results)
    s = {p: v.summary() for p, v in ref.items()}
    assert checks == {
        "sharing_beats_exclusive":
            s["sjf-bsbf"]["avg_jct"] < s["sjf"]["avg_jct"],
        "bsbf_within_ffs_plus_5pct":
            s["sjf-bsbf"]["avg_jct"] <= s["sjf-ffs"]["avg_jct"] * 1.05}


@pytest.mark.parametrize("decision", ["grid", "batched"])
def test_calibrated_mode_decision_paths_agree(decision):
    base = cluster_scheduling.calibrated_run(_payload(), seed=2,
                                             policies=("sjf-bsbf",))
    other = cluster_scheduling.calibrated_run(_payload(), seed=2,
                                              policies=("sjf-bsbf",),
                                              decision=decision)
    assert base["sjf-bsbf"]["sim"].log == other["sjf-bsbf"]["sim"].log


def test_shared_gpu_training_on_cpu():
    text, out = _stdout(shared_gpu_training.main,
                        ["--device", "cpu", "--batch", "2", "--seq", "32",
                         "--iters", "1"])
    r = out["measurement"]
    for key in ("t_a_solo", "t_b_solo", "t_pair", "xi_a", "xi_b"):
        assert math.isfinite(r[key]) and r[key] > 0, key
    assert r["xi_a"] == r["t_pair"] / r["t_a_solo"]
    want = best_pair_schedule(PairJob(r["t_a_solo"], 400, r["xi_a"]),
                              PairJob(r["t_b_solo"], 200, r["xi_b"]))
    assert out["decision"] == want
    assert "Theorem 1 decision" in text
