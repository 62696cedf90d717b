"""Shared pytest configuration: hypothesis settings profiles.

Two profiles, selected via the ``HYPOTHESIS_PROFILE`` environment
variable (default ``dev``):

* ``ci`` — what the GitHub workflow runs: >= 200 examples per property,
  no per-example deadline (the differential fuzz harness replays five
  simulations per example), and **derandomized** — the example stream is
  derived from each test's source, so a CI failure reproduces exactly
  with ``HYPOTHESIS_PROFILE=ci pytest <nodeid>`` and shrunk
  counterexamples can be pasted into the regression corpus
  (``tests/test_engine_equivalence.py::REGRESSION_SPECS``).
* ``dev`` — fast local iteration: few examples, still no deadline.

Without the ``[test]`` extra installed this module is inert and the
property tests skip via ``tests/_hypothesis_compat.py``.
"""
import os

# Hermetic kernels: the committed artifacts/bench/autotune.json must not
# reroute kernel tests through the XLA reference (that would silently
# drop Pallas coverage) — tests that exercise tuned routing install a
# table explicitly via autotune.set_table().
os.environ.setdefault("REPRO_AUTOTUNE", "0")

try:
    from hypothesis import HealthCheck, settings
except ModuleNotFoundError:   # pragma: no cover - no [test] extra
    settings = None

if settings is not None:
    settings.register_profile(
        "ci", max_examples=200, deadline=None, derandomize=True,
        suppress_health_check=[HealthCheck.too_slow])
    settings.register_profile("dev", max_examples=20, deadline=None)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))


def pytest_configure(config):
    # The fleet tests mark themselves with @pytest.mark.timeout so CI
    # (which installs pytest-timeout via the [test] extra) kills a hung
    # multi-process run instead of stalling the job. Locally, without
    # the plugin, register the marker so the mark is a harmless no-op —
    # the master's own phase_timeout is the in-process backstop.
    config.addinivalue_line(
        "markers",
        "timeout(seconds): per-test timeout (enforced only when "
        "pytest-timeout is installed)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips without one")
