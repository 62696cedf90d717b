"""Every cell, configuration, traffic mix, limits file and per-layer
metric of ``BENCHMARK.json`` is a file of its own, found by name, and
the file keeps to the rules a BENCHMARK.json keeps (names, units,
keys, bounds)."""
import json
import os
import re

import pytest

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"executor", "step", "model", "kernels", "device"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["layer"] in LAYERS and m["moves"] == "train_tokens_per_s"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_loads_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c["jobs"] and c["per_layer"]
    for j in c["jobs"]:
        assert j["batch"] % j["sub_batch"] == 0
    limits = json.load(open(os.path.join(
        ROOT, "portbench", "limits", f"{cell}.json")))["limits"]
    assert set(limits) == {j["name"] for j in c["jobs"]}


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_metric_reader_by_name(metric):
    mod = harness.metric_reader(ROOT, metric)
    entry = {m["name"]: m for m in bench()["per_layer"]}[metric]
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["moves"])
    assert callable(mod.read)


def test_every_config_is_used_and_files_are_distinct():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for c in b["configs"]:
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        harness.check_config(conf)


def test_a_config_that_departs_from_its_source_is_refused():
    conf = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                       "minicpm-2b.json")))
    conf["run"]["d_ff"] = 5761
    with pytest.raises(ValueError):
        harness.check_config(conf)


def test_judge_compares_each_number_with_its_limit():
    from portbench import check
    limits = {"a": {"loss_gap": 1e-3, "grad_gap": 0.01, "change_gap": None}}
    sound = {"a": {"loss_gap": 5e-4, "grad_gap": 0.005, "change_gap": 0.3}}
    assert check.judge(sound, limits)[0]
    assert not check.judge({"a": dict(sound["a"], grad_gap=0.02)}, limits)[0]
    assert not check.judge({"a": dict(sound["a"], change_gap=float("nan"))},
                           limits)[0]
    checks = check.judge(sound, limits)[1]
    assert checks["a.change_gap"] == {"value": 0.3, "limit": None}


@pytest.mark.parametrize("traffic", sorted(
    f[:-5] for f in os.listdir(os.path.join(ROOT, "portbench", "traffic"))))
def test_every_traffic_mix_makes_a_cell_as_data(tmp_path, traffic):
    """Each traffic mix, with minicpm-2b, is a cell the harness loads
    from data alone: a BENCHMARK.json entry is all a cell adds (the
    shared mix's cell is measured but not in BENCHMARK.json; PERF.md
    says why)."""
    b = bench()
    name = f"minicpm-2b.{traffic}"
    b["workloads"] = [{"name": name, "config": "minicpm-2b",
                       "traffic": traffic, "chips": 1, "why": "t"}]
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    os.symlink(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    c = harness.load_cell(str(tmp_path), name)
    assert c["jobs"][0]["name"] == "minicpm-2b"
    limits = json.load(open(os.path.join(
        ROOT, "portbench", "limits", f"{name}.json")))["limits"]
    assert set(limits) == {j["name"] for j in c["jobs"]}
