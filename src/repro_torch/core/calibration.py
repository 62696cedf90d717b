"""Closed-loop calibration (the port's copy of the reference's
``core/calibration.py``, with its measuring half in PyTorch).

The simulator's performance model has two measured inputs, which the
paper takes on its 2080 Ti testbed: the Eq.-3 compute coefficients
(t_comp(b) = alpha + beta*b, fitted from a sub-batch sweep) and the
pairwise interference ratios xi (Eqs. 5-6, measured by really co-running
job pairs). :func:`run_calibration` produces both on the device by
driving the schedule executor (:mod:`launch.cluster`) over real training
jobs and returns a **versioned artifact** that the simulator side loads
back:

* ``InterferenceModel.from_artifact`` fills the xi pair table;
* :func:`perf_params_from_artifact` rebuilds Eq.-3/4/7 ``PerfParams``
  from the fitted alpha/beta (single-device jobs: the comm term is
  inside the measured step, so t_comm = 0);
* :class:`MeasuredTaskProfile` carries them per arch.

Artifact schema (version 1, the reference's)::

    {"version": 1, "created": t, "host": {...}, "iters": n,
     "archs": {name: {"arch", "batch", "seq", "accum_steps",
                      "sweep": {"sub_batches": [...], "times": [...]},
                      "alpha_comp", "beta_comp", "t_iter_solo",
                      "n_params", "param_bytes", "mem_base",
                      "mem_per_sample"}},
     "pairs": {"a+b": {"a", "b", "t_a_solo", "t_b_solo", "t_pair",
                       "xi_a", "xi_b", "iters",
                       "xi_a_structural", "xi_b_structural"}}}

The port writes ``host`` as ``{"backend": "gpu" | "cpu", "device_count",
"kind"}``, ``kind`` being the card's name. Module-level imports are the
standard library's: the artifact/fit/profile side serves the simulator,
and the measurement entry point imports the executor when called.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from ..util.errors import ArtifactVersionError
from .perf_model import GPU_2080TI, HardwareSpec, PerfParams, fit_comp_params

if TYPE_CHECKING:
    from repro_torch.launch.cluster import JobSpec

CALIBRATION_VERSION = 1


# ---------------------------------------------------------------------- #
# Artifact I/O
# ---------------------------------------------------------------------- #
def save_artifact(payload: Dict, path: str) -> str:
    if payload.get("version") != CALIBRATION_VERSION:
        raise ValueError(f"refusing to save artifact with version "
                         f"{payload.get('version')!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def load_artifact(path: str) -> Dict:
    with open(path) as f:
        payload = json.load(f)
    version = payload.get("version")
    if version != CALIBRATION_VERSION:
        raise ArtifactVersionError(
            path, version, CALIBRATION_VERSION,
            kind="calibration artifact",
            detail="re-run `python -m repro_torch.launch.calibrate` to "
                   "regenerate")
    return payload


# ---------------------------------------------------------------------- #
# Simulator-side consumers
# ---------------------------------------------------------------------- #
def perf_params_from_artifact(entry: Dict, *, delta: float = 2.0
                              ) -> PerfParams:
    """Eq.-3/4/7 coefficients from one measured arch entry. Single-device
    measurements fold any collective cost into the fitted alpha/beta, so
    the explicit comm term is zero."""
    return PerfParams(
        alpha_comp=float(entry["alpha_comp"]),
        beta_comp=float(entry["beta_comp"]),
        alpha_comm=0.0,
        beta_comm=0.0,
        msg_bytes=0.0,
        delta=delta,
        mem_base=float(entry["mem_base"]),
        mem_per_sample=float(entry["mem_per_sample"]),
        param_bytes=float(entry["param_bytes"]),
        n_workers=1,
    )


@dataclass(frozen=True)
class MeasuredTaskProfile:
    """One measured arch: its default batch and the device-measured
    PerfParams, returned whatever GPU count / hardware spec is asked for
    (the measurement already is the physical truth for this device)."""

    name: str
    default_batch: int
    params: PerfParams

    def perf_params(self, n_gpus: int,
                    hw: HardwareSpec = GPU_2080TI) -> PerfParams:
        return self.params


def profiles_from_artifact(payload: Dict) -> Dict[str, MeasuredTaskProfile]:
    return {
        name: MeasuredTaskProfile(
            name=name,
            default_batch=int(entry["batch"]),
            params=perf_params_from_artifact(entry))
        for name, entry in payload["archs"].items()
    }


# ---------------------------------------------------------------------- #
# Measurement pipeline (imports the executor when called)
# ---------------------------------------------------------------------- #
def _sweep_points(batch: int, sub_batches: Optional[Sequence[int]]
                  ) -> List[int]:
    if sub_batches is not None:
        pts = sorted({int(b) for b in sub_batches if 1 <= b <= batch},
                     reverse=True)
    else:
        from .batch_scaling import candidate_sub_batches
        pts = candidate_sub_batches(batch)
    if len(pts) < 2:
        raise ValueError(
            f"need >= 2 sub-batch sweep points for the Eq.-3 fit; "
            f"batch={batch} gives {pts}")
    return pts


def run_calibration(
    specs: Dict[str, "JobSpec"],
    *,
    iters: int = 3,
    sub_batches: Optional[Sequence[int]] = None,
    pairs: Optional[Sequence[Tuple[str, str]]] = None,
    device=None,
) -> Dict:
    """Measure everything the simulator needs, on ``device`` (the card
    unless ``device="cpu"``).

    Per arch: a sub-batch sweep (each point really trains the model at
    per-step batch b, accum=1, timing steps after a warm-up through the
    executor) fitted to t_comp(b) = alpha + beta*b; the solo iteration
    time at the spec's own (batch, accum); and the reference's analytic
    memory coefficients (param/optimizer bytes from the real parameter
    count, activation bytes per sample from the config dims). Per pair
    (default all unordered pairs incl. self-pairings, or an explicit
    list): the pair step's time and the xi ratios.

    Every measurement starts from the pristine state, **rebuilt from the
    spec's seed** by the executor (init and data are seeded, so the
    rebuilt state is bitwise the pristine one); a sweep point at b
    differs only in its data, drawn at b. No master copy is held: at full
    width minicpm-2b's state alone (bf16 params, f32 moments) is 27.3 GB,
    and masters of both archs beside a pair's working states would not
    fit one 80 GB card. A self-pair builds two states from one seed,
    which share no tensor (the executor updates params in place)."""
    import dataclasses as _dc

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import init_params, param_count

    from .coschedule import measure_pair, measure_solo, structural_xi

    dev = resolve_device(device)
    names = sorted(specs)
    archs: Dict[str, Dict] = {}
    solo: Dict[str, float] = {}

    for name in names:
        spec = specs[name]
        cfg = spec.cfg
        pts = _sweep_points(spec.batch, sub_batches)
        times = []
        for b in pts:
            # per-micro-step time at sub-batch b: one step at batch=b, no
            # accumulation (Eq. 3 is about the micro-step)
            sub_spec = _dc.replace(spec, batch=b, accum_steps=1)
            times.append(measure_solo(sub_spec, iters, device=dev))
        alpha, beta = fit_comp_params([float(b) for b in pts], times)
        if spec.accum_steps == 1 and pts[0] == spec.batch:
            # the sweep's first point IS the spec's own configuration
            solo[name] = times[0]
        else:
            solo[name] = measure_solo(spec, iters, device=dev)
        # shapes alone: a second copy of the weights on the card would
        # only be counted
        n_params = param_count(init_params(cfg, spec.seed, device="meta"))
        param_bytes = 4.0 * n_params
        # params + grads + AdamW moments, plus a small framework floor
        mem_base = 4.0 * param_bytes + 64 * 2 ** 20
        act_per_sample = 4.0 * spec.seq * cfg.d_model * (cfg.n_layers + 2)
        archs[name] = {
            "arch": cfg.name,
            "batch": spec.batch,
            "seq": spec.seq,
            "accum_steps": spec.accum_steps,
            "sweep": {"sub_batches": pts, "times": times},
            "alpha_comp": alpha,
            "beta_comp": beta,
            "t_iter_solo": solo[name],
            "n_params": int(n_params),
            "param_bytes": param_bytes,
            "mem_base": mem_base,
            "mem_per_sample": act_per_sample,
        }

    if pairs is None:
        pairs = [(a, b) for i, a in enumerate(names) for b in names[i:]]
    pair_entries: Dict[str, Dict] = {}
    for a, b in pairs:
        r = measure_pair(specs[a], specs[b], iters=iters,
                         t_a_solo=solo[a], t_b_solo=solo[b], device=dev)
        pair_entries[f"{a}+{b}"] = {
            "a": a, "b": b, **r,
            "xi_a_structural": structural_xi(r["t_a_solo"], r["t_b_solo"]),
            "xi_b_structural": structural_xi(r["t_b_solo"], r["t_a_solo"]),
        }

    cuda = dev.type == "cuda"
    return {
        "version": CALIBRATION_VERSION,
        "created": time.time(),
        "host": {
            "backend": "gpu" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        },
        "iters": iters,
        "archs": archs,
        "pairs": pair_entries,
    }
