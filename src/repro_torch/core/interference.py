"""Interference model: the xi ratios of Eqs. 5-6 (the port's copy of
the reference's ``core/interference.py``, same arithmetic).

The paper measures xi per job pair on 2080 Ti GPUs (Fig. 3), up to ~6x.
Here xi comes from, in order of priority: a global override (the Fig. 6b
sweep), a pair table (filled from a calibration artifact measured by
really co-running job pairs, or from the paper-like table below), and
the structural model of time multiplexing,
    xi_A ~= 1 + r * (t_B / t_A)
with r in [0, 1] the contention coefficient (r = 1 is strict time
multiplexing) plus a memory-pressure correction.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

Key = Tuple[str, str]


def structural_xi(
    t_me: float,
    t_other: float,
    *,
    contention: float = 1.0,
    ratio_cap: Optional[float] = None,
    mem_frac: float = 0.0,
    hbm_pressure: float = 0.15,
) -> float:
    """The structural interference model, the one implementation behind
    the scheduler's :meth:`InterferenceModel.xi` fallback and the
    analytic prediction ``core.coschedule.structural_xi``.

    Strict time multiplexing of two programs gives
    ``xi_me = 1 + t_other / t_me``; ``contention`` in [0, 1] scales the
    co-tenant term (1 = no overlap between the programs, < 1 credits
    pipelined compute/collective overlap), ``ratio_cap`` optionally clamps
    the timing ratio (the scheduler's table-free fallback caps it at 4 so
    one pathological pairing cannot dominate a whole schedule), and an
    HBM-pressure term penalizes near-capacity combined working sets.
    """
    ratio = t_other / max(t_me, 1e-12)
    if ratio_cap is not None and ratio > ratio_cap:
        ratio = ratio_cap
    xi = 1.0 + contention * ratio
    if mem_frac > 0.8:
        xi += hbm_pressure * (mem_frac - 0.8) / 0.2
    return xi


@dataclass
class InterferenceModel:
    """Returns (xi_for_me, xi_for_other) when ``me`` shares GPUs with
    ``other``. Priority: global override > pair table > structural model."""

    # contention coefficient of the structural model; r=1 -> pure
    # time-multiplexing (xi_A = 1 + t_B/t_A), r<1 -> partial overlap.
    contention: float = 0.35
    # extra slowdown when combined working set approaches HBM capacity
    hbm_pressure: float = 0.15
    table: Dict[Key, Tuple[float, float]] = field(default_factory=dict)
    global_xi: Optional[float] = None   # Fig. 6b style injection

    def set_pair(self, a: str, b: str, xi_a: float, xi_b: float) -> None:
        self.table[(a, b)] = (xi_a, xi_b)
        self.table[(b, a)] = (xi_b, xi_a)

    def pair_fixed(self, me: str, other: str) -> Optional[Tuple[float, float]]:
        """(xi_me, xi_other) when both directions are independent of
        timing/memory — a global override or a two-way table hit — so
        callers sweeping sub-batches can hoist the lookup out of the
        loop. None when the structural model applies to either side."""
        if self.global_xi is not None:
            return self.global_xi, self.global_xi
        a = self.table.get((me, other))
        if a is None:
            return None
        b = self.table.get((other, me))
        if b is None:
            return None
        return a[0], b[0]

    def xi(
        self,
        me: str,
        other: str,
        *,
        t_me: float = 1.0,
        t_other: float = 1.0,
        mem_frac: float = 0.0,
    ) -> float:
        """Interference ratio applied to ``me``'s iteration time.

        ``t_me``/``t_other`` are the solo iteration times (used by the
        structural model), ``mem_frac`` the fraction of device memory used
        by the pair together."""
        if self.global_xi is not None:
            return self.global_xi
        hit = self.table.get((me, other))
        if hit is not None:
            return hit[0]
        return structural_xi(t_me, t_other, contention=self.contention,
                             ratio_cap=4.0, mem_frac=mem_frac,
                             hbm_pressure=self.hbm_pressure)

    # ------------------------------------------------------------------ #
    @classmethod
    def from_artifact(cls, artifact: Union[str, Dict],
                      **overrides) -> "InterferenceModel":
        """Build the pair table from a calibration artifact: xi measured
        by really co-running job pairs (``core.calibration``) in place of
        the synthesized :func:`paper_interference_model` table.

        ``artifact`` is either the payload dict or a path to a versioned
        calibration artifact; its schema is owned by
        :mod:`core.calibration`."""
        from .calibration import CALIBRATION_VERSION, load_artifact
        if isinstance(artifact, str):
            if not os.path.exists(artifact):
                raise FileNotFoundError(
                    f"calibration artifact not found: {artifact!r} "
                    "(run `python -m repro_torch.launch.calibrate` to "
                    "produce one)")
            artifact = load_artifact(artifact)
        version = artifact.get("version")
        if version != CALIBRATION_VERSION:
            raise ValueError(
                f"unsupported calibration artifact version {version!r}")
        model = cls(**overrides)
        for entry in artifact["pairs"].values():
            model.set_pair(entry["a"], entry["b"],
                           float(entry["xi_a"]), float(entry["xi_b"]))
        return model


# Paper-like pair table for the six Pollux/paper DL tasks. The paper does
# not publish the raw xi matrix; these values are synthesized to match the
# reported qualitative structure (range up to ~6, compute-bound pairs ~1.6-2,
# comm-bound pairs lighter, memory-heavy pairs severe). Used by the
# paper-faithful benchmarks; the Fig. 6b sweep overrides them globally.
PAPER_TASKS = ("bert", "cifar10", "deepspeech2", "imagenet", "ncf", "yolov3")


def paper_interference_model() -> InterferenceModel:
    m = InterferenceModel()
    base = {
        # (a, b): xi_a when a shares with b  (diagonal = self-pairing).
        # Mostly mild (1.1-1.5); a few bad pairings (compute-saturating
        # YoloV3/ImageNet combos) reach 2-6x, matching the reported range.
        ("bert", "bert"): 1.55, ("bert", "cifar10"): 1.15,
        ("bert", "deepspeech2"): 1.30, ("bert", "imagenet"): 1.45,
        ("bert", "ncf"): 1.20, ("bert", "yolov3"): 1.80,
        ("cifar10", "cifar10"): 1.12, ("cifar10", "bert"): 1.25,
        ("cifar10", "deepspeech2"): 1.20, ("cifar10", "imagenet"): 1.30,
        ("cifar10", "ncf"): 1.10, ("cifar10", "yolov3"): 1.45,
        ("deepspeech2", "deepspeech2"): 1.40, ("deepspeech2", "bert"): 1.35,
        ("deepspeech2", "cifar10"): 1.18, ("deepspeech2", "imagenet"): 1.35,
        ("deepspeech2", "ncf"): 1.15, ("deepspeech2", "yolov3"): 1.60,
        ("imagenet", "imagenet"): 1.75, ("imagenet", "bert"): 1.50,
        ("imagenet", "cifar10"): 1.25, ("imagenet", "deepspeech2"): 1.40,
        ("imagenet", "ncf"): 1.18, ("imagenet", "yolov3"): 2.30,
        ("ncf", "ncf"): 1.15, ("ncf", "bert"): 1.25,
        ("ncf", "cifar10"): 1.10, ("ncf", "deepspeech2"): 1.18,
        ("ncf", "imagenet"): 1.30, ("ncf", "yolov3"): 1.40,
        ("yolov3", "yolov3"): 5.8, ("yolov3", "bert"): 1.95,
        ("yolov3", "cifar10"): 1.50, ("yolov3", "deepspeech2"): 1.75,
        ("yolov3", "imagenet"): 2.60, ("yolov3", "ncf"): 1.45,
    }
    for (a, b), xi_a in base.items():
        xi_b = base.get((b, a), xi_a)
        m.table[(a, b)] = (xi_a, xi_b)
    return m
