"""Segment retry in the port's ``DecodeEngine`` (twins of
``TestSegmentRetry`` in ``tests/test_serve_degradation.py``): a scripted
transient fault before a segment is retried and leaves the tokens those
of the fault-free run; one that outlasts the policy propagates. On a
reduced f32 config on the CPU.

Each test runs the reference's engine beside the port's, with the same
weights (the reference's ``init_params(cfg, PRNGKey(0))``, carried into
the port by ``params_from_numpy``), prompts, fault script and policy:
the tokens and every counter of the reference's ``stats`` must agree
exactly."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.checkpoint.npz import _flatten as ref_flatten
from repro.configs import get_config as ref_get_config
from repro.launch import cluster as ref_cluster
from repro.launch.engine import DecodeEngine as RefDecodeEngine
from repro.models import init_params as ref_init_params
from repro.util.retry import RetryPolicy as RefRetryPolicy
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch.cluster import (FaultSpec, ScriptedFaults,
                                        TransientFault)
from repro_torch.launch.engine import DecodeEngine
from repro_torch.util.retry import RetryPolicy
from _torch_threads import one_torch_thread  # noqa: F401

_SETUP = {}


def _setup(seed=0):
    """Both packages' configs and the same weights in each, and prompts
    drawn as the reference's tests draw them."""
    if seed not in _SETUP:
        cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                                  dtype="float32")
        ref_cfg = dataclasses.replace(ref_get_config("minicpm-2b").reduced(),
                                      dtype="float32")
        ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(seed))
        params = params_from_numpy(ref_flatten(ref_params), device="cpu")
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab, (4,)).astype(np.int32)
                   for _ in range(4)]
        _SETUP[seed] = (cfg, params, ref_cfg, ref_params, prompts)
    return _SETUP[seed]


def _engines(script=(), policy=None, **kw):
    """The port's engine and the reference's, built alike."""
    cfg, params, ref_cfg, ref_params, _ = _setup()
    kw.setdefault("n_slots", 1)
    kw.setdefault("max_len", 32)
    kw.setdefault("segment", 4)
    kw["sleep"] = lambda d: None

    def build(cls, faults_cls, spec_cls, policy_cls, c, p):
        extra = dict(kw)
        if script:
            extra["fault_injector"] = faults_cls(
                [spec_cls(call=call, job="segment", times=times)
                 for call, times in script])
        if policy is not None:
            extra["retry_policy"] = policy_cls(**policy)
        return cls(c, p, **extra)

    return (build(DecodeEngine, ScriptedFaults, FaultSpec, RetryPolicy,
                  cfg, params),
            build(RefDecodeEngine, ref_cluster.ScriptedFaults,
                  ref_cluster.FaultSpec, RefRetryPolicy, ref_cfg,
                  ref_params))


def _same_run(port, ref, prompts, tokens=8):
    """Submit the same requests to both engines, run both to the end and
    compare tokens and counters; returns the port's outputs."""
    for p in prompts:
        port.submit(p, tokens)
        ref.submit(p, tokens)
    got, want = port.run(), ref.run()
    assert got == want
    for key, value in ref.stats.items():
        assert port.stats[key] == value, key
    assert port.shed == ref.shed
    return got


class TestSegmentRetry:
    @pytest.mark.parametrize("paged", [False, True])
    def test_transient_segment_fault_retried_token_identical(self, paged):
        prompts = _setup()[-1]
        kw = {"paged": True, "page_size": 8} if paged else {}
        want, ref_want = _engines(**kw)
        out_want = _same_run(want, ref_want, prompts[:1])

        eng, ref = _engines(script=[(0, 1)],
                            policy=dict(attempts=3, base=0.0), **kw)
        out = _same_run(eng, ref, prompts[:1])
        assert out == out_want
        assert eng.stats["retries"] == 1
        assert eng.stats["segments"] == want.stats["segments"]
        assert eng.shed == {}

    def test_exhausted_segment_retry_propagates(self):
        prompts = _setup()[-1]
        eng, ref = _engines(script=[(0, 2)],
                            policy=dict(attempts=2, base=0.0))
        for side, fault in ((eng, TransientFault),
                            (ref, ref_cluster.TransientFault)):
            side.submit(prompts[0], 8)
            with pytest.raises(fault):
                side.run()
        for key, value in ref.stats.items():
            assert eng.stats[key] == value, key
        assert eng.stats["segments"] == 0


def test_retry_knobs_off_are_token_identical():
    """A policy with no injector changes nothing."""
    prompts = _setup()[-1]
    plain, ref_plain = _engines(n_slots=2)
    want = _same_run(plain, ref_plain, prompts[:3])
    knobs, ref_knobs = _engines(n_slots=2, policy=dict(attempts=2),
                                retry_seed=5)
    assert _same_run(knobs, ref_knobs, prompts[:3]) == want
    assert knobs.stats["retries"] == 0
