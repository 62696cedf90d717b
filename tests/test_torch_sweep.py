"""The port's sweep against the reference's: ``run_sweep`` rows and
``to_canonical_json`` bytes equal the reference's for a small grid, with
one worker and with two (spawned workers that import ``repro_torch``
only), and the CSV, JSON and table writers give the reference's text."""
import pytest

import repro.core.sweep as RS
import repro_torch.core.sweep as PS

SPEC = dict(n_jobs=24, n_servers=4, gpus_per_server=4, engine="heap",
            decision="grid",
            collect=("jct_deciles", "queue_by_model", "queue_percentiles"))


def _grid(mod):
    return (mod.grid(["fifo", "SJF_BSBF", "tiresias", "pollux"],
                     seeds=(0, 1), **SPEC)
            + mod.grid(["sjf-ffs", "srsf"], trace="physical", **{
                k: v for k, v in SPEC.items() if k != "n_jobs"})
            + mod.grid(["sjf-bsbf"], trace="philly", n_jobs=60,
                       n_servers=4, gpus_per_server=8, decision="batched",
                       loads=(1.0, 1.1)))


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "wall_seconds"}
            for r in rows]


@pytest.fixture(scope="module")
def ref_rows():
    return RS.run_sweep(_grid(RS), workers=1)


@pytest.mark.parametrize("workers", [1, 2])
def test_sweep_equals_reference(workers, ref_rows):
    rows = PS.run_sweep(_grid(PS), workers=workers)
    assert _strip(rows) == _strip(ref_rows)
    assert PS.to_canonical_json(rows) == RS.to_canonical_json(ref_rows)
    assert {r["decision"] for r in rows} == {"grid", "batched"}


def test_writers_equal_reference(ref_rows, tmp_path):
    rows = PS.run_sweep(_grid(PS), workers=1)
    for writer in ("write_csv", "write_json"):
        port = getattr(PS, writer)(rows, str(tmp_path / f"p_{writer}"))
        ref = getattr(RS, writer)(ref_rows, str(tmp_path / f"r_{writer}"))
        assert open(port, "rb").read() == open(ref, "rb").read()
    assert PS.summary_table(rows, "t") == RS.summary_table(ref_rows, "t")
    assert PS.rows_by_policy(rows) == RS.rows_by_policy(ref_rows)


def test_spec_defaults_resolve_to_the_ports_paths():
    row = PS.run_scenario(PS.ScenarioSpec(policy="sjf-bsbf", n_jobs=10,
                                          n_servers=4))
    assert (row["engine"], row["decision"]) == ("heap", "scalar")
    with pytest.raises(ValueError, match="unknown policy 'lottery'"):
        PS.normalize_policy("lottery")
    with pytest.raises(ValueError, match="unknown collect metric"):
        PS.run_scenario(PS.ScenarioSpec(policy="fifo", collect=("p42",)))
    with pytest.raises(ValueError, match="unknown trace kind"):
        PS.run_scenario(PS.ScenarioSpec(policy="fifo", trace="borg"))
