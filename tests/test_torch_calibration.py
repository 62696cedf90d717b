"""The port's calibration against the reference's: under the same
deterministic stand-in for the measurements, ``run_calibration`` gives
the reference's artifact (all but ``created`` and ``host``); each
package reads the other's saved artifact to the same PerfParams and xi
table; and a real run on the CPU writes the version-1 schema with finite
positive times."""
import dataclasses
import math

import pytest

import repro.core.coschedule as ref_cos
from repro.configs import get_config as ref_get_config
from repro.core.calibration import (load_artifact as ref_load,
                                    perf_params_from_artifact as ref_perf,
                                    profiles_from_artifact as ref_profiles,
                                    run_calibration as ref_run,
                                    save_artifact as ref_save)
from repro.core.interference import InterferenceModel as RefInterference
from repro.launch.cluster import JobSpec as RefJobSpec
from repro_torch.core import coschedule
from repro_torch.core.calibration import (CALIBRATION_VERSION,
                                          load_artifact,
                                          perf_params_from_artifact,
                                          profiles_from_artifact,
                                          run_calibration, save_artifact)
from repro_torch.core.interference import InterferenceModel
from repro_torch.launch.calibrate import build_specs, select_pairs
from repro_torch.util import ArtifactVersionError
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("minicpm-2b", "qwen2-vl-2b")
ARCH_KEYS = {"arch", "batch", "seq", "accum_steps", "sweep", "alpha_comp",
             "beta_comp", "t_iter_solo", "n_params", "param_bytes",
             "mem_base", "mem_per_sample"}
PAIR_KEYS = {"a", "b", "t_a_solo", "t_b_solo", "t_pair", "xi_a", "xi_b",
             "iters", "xi_a_structural", "xi_b_structural"}


def _t(spec):
    """A deterministic stand-in for a measured step time."""
    return 0.0123 + 0.00417 * spec.batch + 0.0031 * spec.accum_steps \
        + 1e-3 * spec.cfg.d_model / 256


def fake_solo(spec, iters=3, **_):
    return _t(spec)


def fake_pair(a, b, iters=3, *, t_a_solo=None, t_b_solo=None, **_):
    t_a = _t(a) if t_a_solo is None else t_a_solo
    t_b = _t(b) if t_b_solo is None else t_b_solo
    t_pair = t_a + t_b + 0.0007
    return {"t_a_solo": t_a, "t_b_solo": t_b, "t_pair": t_pair,
            "xi_a": t_pair / t_a, "xi_b": t_pair / t_b, "iters": iters}


@pytest.fixture
def fake_measurements(monkeypatch):
    for mod in (coschedule, ref_cos):
        monkeypatch.setattr(mod, "measure_solo", fake_solo)
        monkeypatch.setattr(mod, "measure_pair", fake_pair)


def _ref_specs(batch=4, seq=64, accum_steps=1):
    return {name: RefJobSpec(dataclasses.replace(
        ref_get_config(name).reduced(), dtype="float32"), batch=batch,
        seq=seq, seed=i, accum_steps=accum_steps)
        for i, name in enumerate(ARCHS)}


def _port_specs(batch=4, seq=64, accum_steps=1):
    return {name: dataclasses.replace(spec, accum_steps=accum_steps)
            for name, spec in build_specs(ARCHS, batch=batch, seq=seq,
                                          reduced=True).items()}


def _strip(payload):
    return {k: v for k, v in payload.items() if k not in ("created", "host")}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(pairs=[("minicpm-2b", "qwen2-vl-2b")]),
    dict(sub_batches=[1, 3, 4], accum_steps=2),
], ids=["all-pairs", "cross-pair", "own-sweep-and-accum"])
def test_artifact_equals_the_reference(fake_measurements, kw):
    accum = kw.pop("accum_steps", 1)
    port = run_calibration(_port_specs(accum_steps=accum), iters=2,
                           device="cpu", **kw)
    ref = ref_run(_ref_specs(accum_steps=accum), iters=2, **kw)
    assert _strip(port) == _strip(ref)
    assert port["host"] == {"backend": "cpu", "device_count": 1,
                            "kind": "cpu"}
    assert set(port["archs"]["minicpm-2b"]) == ARCH_KEYS
    assert all(set(e) == PAIR_KEYS for e in port["pairs"].values())


def test_each_package_reads_the_others_artifact(fake_measurements,
                                                tmp_path):
    port = run_calibration(_port_specs(), iters=2, device="cpu")
    ref = ref_run(_ref_specs(), iters=2)
    port_path = save_artifact(port, str(tmp_path / "calibration_cuda.json"))
    ref_path = ref_save(ref, str(tmp_path / "calibration.json"))
    for path in (port_path, ref_path):
        mine, theirs = load_artifact(path), ref_load(path)
        assert mine == theirs
        for name, entry in mine["archs"].items():
            assert (dataclasses.asdict(perf_params_from_artifact(entry))
                    == dataclasses.asdict(ref_perf(entry)))
        a, b = profiles_from_artifact(mine), ref_profiles(theirs)
        assert {n: (p.default_batch, dataclasses.asdict(p.params))
                for n, p in a.items()} == {
            n: (p.default_batch, dataclasses.asdict(p.params))
            for n, p in b.items()}
        assert (InterferenceModel.from_artifact(path).table
                == RefInterference.from_artifact(path).table)


def test_a_stale_artifact_is_refused(tmp_path):
    payload = {"version": CALIBRATION_VERSION, "archs": {}, "pairs": {}}
    path = save_artifact(payload, str(tmp_path / "c.json"))
    assert load_artifact(path) == payload
    with pytest.raises(ValueError, match="version"):
        save_artifact(dict(payload, version=99), path)
    with open(path, "w") as f:
        f.write('{"version": 99}')
    with pytest.raises(ArtifactVersionError, match="found version 99"):
        load_artifact(path)
    with pytest.raises(FileNotFoundError):
        InterferenceModel.from_artifact(str(tmp_path / "none.json"))


def test_calibrate_interference_equals_the_reference(fake_measurements):
    port = coschedule.calibrate_interference(_port_specs(), iters=1,
                                             device="cpu")
    ref = ref_cos.calibrate_interference(_ref_specs(), iters=1)
    assert port.table == ref.table and len(port.table) == 4


@pytest.mark.parametrize("t_me,t_other,kw", [
    (0.5, 0.3, {}), (0.31, 0.52, {"overlap": 0.25}),
    (1.7, 0.2, {"mem_frac": 0.93}), (0.2, 1.7, {"mem_frac": 0.9,
                                                "hbm_pressure": 0.3}),
])
def test_structural_xi_equals_the_reference(t_me, t_other, kw):
    assert (coschedule.structural_xi(t_me, t_other, **kw)
            == ref_cos.structural_xi(t_me, t_other, **kw))


def test_pair_selection():
    assert select_pairs(ARCHS, "all") is None
    assert select_pairs(ARCHS[::-1], "cross") == [tuple(sorted(ARCHS))]
    with pytest.raises(ValueError):
        select_pairs(ARCHS, "some")


def test_real_calibration_on_the_cpu():
    specs = _port_specs(seq=16)
    calls = []
    with coschedule.step_times_recorded(
            lambda: calls.append(None) or len(calls)) as recorded:
        payload = run_calibration(specs, iters=1, device="cpu",
                                  pairs=select_pairs(specs, "cross"))
    # one record per measurement, in order (each arch's sweep, then the
    # pair), each mean the artifact's number, each step probed around
    means = [sum(t) / len(t) for t, _ in recorded]
    assert means == [t for e in payload["archs"].values()
                     for t in e["sweep"]["times"]] + [
        payload["pairs"]["minicpm-2b+qwen2-vl-2b"]["t_pair"]]
    assert [p for _, p in recorded] == [[(2 * i + 1, 2 * i + 2)]
                                        for i in range(7)]
    assert payload["version"] == CALIBRATION_VERSION
    assert payload["host"]["backend"] == "cpu"
    assert list(payload["pairs"]) == ["minicpm-2b+qwen2-vl-2b"]
    for entry in payload["archs"].values():
        assert set(entry) == ARCH_KEYS
        assert entry["sweep"]["sub_batches"] == [4, 2, 1]
        for t in entry["sweep"]["times"] + [entry["t_iter_solo"]]:
            assert math.isfinite(t) and t > 0
        assert entry["n_params"] > 0
    for entry in payload["pairs"].values():
        assert set(entry) == PAIR_KEYS
        for key in ("t_a_solo", "t_b_solo", "t_pair", "xi_a", "xi_b"):
            assert math.isfinite(entry[key]) and entry[key] > 0
    # the helper the means come from: one walltime per timed step
    times = coschedule._step_times([specs["minicpm-2b"]], 2, device="cpu")
    assert len(times) == 2 and all(t > 0 for t in times)
