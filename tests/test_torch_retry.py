"""The port's ``util.retry`` against the reference's: for the same seeds
and policies, the same delays, attempts, results and budget errors."""
import itertools

import pytest

from repro.util import retry as ref
from repro_torch.util import retry as port


class Flaky:
    """Fails its first ``fails`` calls with ``exc``, then returns the
    number of calls made."""

    def __init__(self, fails, exc=ValueError):
        self.fails, self.exc, self.calls = fails, exc, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc(f"failure {self.calls}")
        return self.calls


class Clock:
    """Advances by ``dt`` on every read."""

    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _run(mod, policy_kw, fails, seed, *, exc=ValueError, retry_on=None,
         clock_dt=None):
    sleeps, seen = [], []
    fn = Flaky(fails, exc)
    kw = dict(policy=mod.RetryPolicy(**policy_kw), seed=seed,
              sleep=sleeps.append,
              on_retry=lambda a, e, d: seen.append((a, str(e), d)))
    if retry_on is not None:
        kw["retry_on"] = retry_on
    if clock_dt is not None:
        kw["clock"] = Clock(clock_dt)
    try:
        out = ("ok", mod.retry_call(fn, **kw))
    except mod.RetryBudgetExceeded as e:
        out = ("budget", e.attempts, e.elapsed, e.deadline, str(e.__cause__))
    except Exception as e:      # the last attempt's own exception
        out = ("raised", type(e).__name__, str(e))
    return out, sleeps, seen, fn.calls


POLICIES = [dict(), dict(attempts=5, base=0.1, cap=0.3),
            dict(attempts=4, base=0.05, jitter=False),
            dict(attempts=1), dict(attempts=6, base=1.0, cap=64.0)]


@pytest.mark.parametrize("policy,fails,seed", list(itertools.product(
    range(len(POLICIES)), (0, 1, 3, 7), (0, 11))))
def test_delays_attempts_and_results_equal_the_reference(policy, fails,
                                                         seed):
    kw = POLICIES[policy]
    assert _run(port, kw, fails, seed) == _run(ref, kw, fails, seed)


@pytest.mark.parametrize("deadline,clock_dt", [(0.25, 0.1), (1.0, 0.3),
                                               (0.0, 0.01), (5.0, 0.0)])
def test_deadline_budget_equals_the_reference(deadline, clock_dt):
    kw = dict(attempts=6, base=0.1, cap=2.0, deadline=deadline)
    got = _run(port, kw, 5, 3, clock_dt=clock_dt)
    assert got == _run(ref, kw, 5, 3, clock_dt=clock_dt)


def test_unmatched_exception_is_not_retried():
    for mod in (port, ref):
        out, sleeps, seen, calls = _run(mod, dict(attempts=4), 2, 0,
                                        exc=KeyError, retry_on=(ValueError,))
        assert out[0] == "raised" and out[1] == "KeyError"
        assert calls == 1 and sleeps == [] and seen == []


@pytest.mark.parametrize("kw", [dict(attempts=0), dict(base=-1.0),
                                dict(cap=-0.5), dict(deadline=-1.0)])
def test_policy_validation_matches(kw):
    with pytest.raises(ValueError) as want:
        ref.RetryPolicy(**kw)
    with pytest.raises(ValueError) as got:
        port.RetryPolicy(**kw)
    assert str(got.value) == str(want.value)
