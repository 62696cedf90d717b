"""Solo and pair step timings on one device (the reference's
``core/coschedule.py``): two jobs share the device by time multiplexing
inside one group step, and

    xi_A = t_pair / t_A_solo      (and symmetrically for B)

feeds the scheduler's interference model. Every measurement builds its
own executor, so a job's state is released before the next measurement
starts and a solo run never shares memory with the pair that follows.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.launch.cluster import JobSpec, ScheduleExecutor

__all__ = ["JobSpec", "measure_group", "measure_pair", "measure_solo"]


def _measure(specs, iters: int, states=None, device=None) -> float:
    """Mean seconds per group step over ``iters`` calls after one warm-up
    step (first-call costs such as library handle set-up and the kernel
    build stay out of the mean)."""
    ex = ScheduleExecutor(device=device)
    names = []
    for i, spec in enumerate(specs):
        name = f"j{i}"
        names.append(name)
        ex.submit(name, spec, iters + 1)
        ex.start(name, state=None if states is None else states[i])
    ex.step_group(names)                       # warm-up
    return sum(ex.step_group(names)["walltime"]
               for _ in range(iters)) / iters


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
