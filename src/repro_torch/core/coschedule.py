"""Solo and pair step timings on one device (the reference's
``core/coschedule.py``): two jobs share the device by time multiplexing
inside one group step, and

    xi_A = t_pair / t_A_solo      (and symmetrically for B)

feeds the scheduler's interference model. Every measurement builds its
own executor, so a job's state is released before the next measurement
starts and a solo run never shares memory with the pair that follows.
The whole loop (alpha/beta fits, the versioned artifact) is
:func:`core.calibration.run_calibration`.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

from repro_torch.launch.cluster import JobSpec, ScheduleExecutor

from .interference import InterferenceModel
from .interference import structural_xi as _structural_xi

__all__ = ["JobSpec", "calibrate_interference", "measure_group",
           "measure_pair", "measure_solo", "step_times_recorded",
           "structural_xi"]

# the open recorders of step_times_recorded, innermost last
_recorders: List[tuple] = []


@contextlib.contextmanager
def step_times_recorded(probe: Optional[Callable[[], Any]] = None):
    """Yields a list that receives, for every measurement made inside the
    block and in call order, ``(times, probes)``: the seconds of each of
    its timed steps (of which the measured mean is the mean), and, when
    ``probe`` is given, its readings ``(before, after)`` around each timed
    step, outside the step's own clock."""
    sink: List[tuple] = []
    _recorders.append((sink, probe))
    try:
        yield sink
    finally:
        _recorders.remove((sink, probe))


def _step_times(specs, iters: int, states=None, device=None) -> List[float]:
    """Seconds of each of ``iters`` group steps after one warm-up step
    (first-call costs such as library handle set-up and the kernel build
    stay out). Their spread says how far one mean can be trusted."""
    ex = ScheduleExecutor(device=device)
    names = []
    for i, spec in enumerate(specs):
        name = f"j{i}"
        names.append(name)
        ex.submit(name, spec, iters + 1)
        ex.start(name, state=None if states is None else states[i])
    ex.step_group(names)                       # warm-up
    sink, probe = _recorders[-1] if _recorders else (None, None)
    times, probes = [], []
    for _ in range(iters):
        before = probe() if probe is not None else None
        times.append(ex.step_group(names)["walltime"])
        if probe is not None:
            probes.append((before, probe()))
    if sink is not None:
        sink.append((times, probes))
    return times


def _measure(specs, iters: int, states=None, device=None) -> float:
    """Mean seconds per group step of :func:`_step_times`."""
    return sum(_step_times(specs, iters, states, device)) / iters


def measure_solo(spec: JobSpec, iters: int = 3, *,
                 state: Optional[tuple] = None, device=None) -> float:
    """Mean seconds per solo training step. ``state`` takes a prebuilt
    (params, opt, batch), which the steps update in place."""
    return _measure([spec], iters, None if state is None else [state],
                    device)


def measure_pair(spec_a: JobSpec, spec_b: JobSpec, iters: int = 3, *,
                 t_a_solo: Optional[float] = None,
                 t_b_solo: Optional[float] = None,
                 state_a: Optional[tuple] = None,
                 state_b: Optional[tuple] = None,
                 device=None) -> Dict[str, float]:
    """Times the interleaved pair step and returns per-step solo/pair
    walltimes and the structural interference ratios xi_A, xi_B."""
    t_a = (measure_solo(spec_a, iters, device=device)
           if t_a_solo is None else t_a_solo)
    t_b = (measure_solo(spec_b, iters, device=device)
           if t_b_solo is None else t_b_solo)
    t_pair = _measure([spec_a, spec_b], iters,
                      None if state_a is None and state_b is None
                      else [state_a, state_b], device)
    return {
        "t_a_solo": t_a,
        "t_b_solo": t_b,
        "t_pair": t_pair,
        "xi_a": t_pair / t_a,
        "xi_b": t_pair / t_b,
        "iters": iters,
    }


def measure_group(specs, iters: int = 3, states=None, device=None) -> float:
    """Mean seconds per N-way group step."""
    return _measure(list(specs), iters, states, device)


def structural_xi(t_me: float, t_other: float, *, overlap: float = 0.0,
                  mem_frac: float = 0.0, hbm_pressure: float = 0.15
                  ) -> float:
    """Analytic structural model (no execution): strict time multiplexing
    gives xi_me = 1 + t_other/t_me; ``overlap`` in [0,1) credits
    pipelined overlap between the two programs. The shared
    implementation (with the scheduler's ratio clamp parameterized away)
    is :func:`core.interference.structural_xi`."""
    return _structural_xi(t_me, t_other, contention=1.0 - overlap,
                          ratio_cap=None, mem_frac=mem_frac,
                          hbm_pressure=hbm_pressure)


def calibrate_interference(specs: Dict[str, JobSpec], iters: int = 2,
                           device=None) -> InterferenceModel:
    """Fill an InterferenceModel table from real pairwise measurements on
    ``device``. Solo timings are measured once per spec and reused for
    every pair. The full pipeline (alpha/beta fits, memory estimates, the
    versioned artifact) is :func:`core.calibration.run_calibration`."""
    model = InterferenceModel()
    names = sorted(specs)
    solo = {name: measure_solo(specs[name], iters, device=device)
            for name in names}
    for i, a in enumerate(names):
        for b in names[i:]:
            r = measure_pair(specs[a], specs[b], iters=iters,
                             t_a_solo=solo[a], t_b_solo=solo[b],
                             device=device)
            model.set_pair(a, b, r["xi_a"], r["xi_b"])
    return model
