"""Calibration entry point of the port (the twin of the reference's
``benchmarks/xi_calibration.py``): really train each arch on the device
through the schedule executor, fit the Eq.-3 alpha/beta from the measured
sub-batch sweep, measure pairwise xi on the pair steps, and write the
versioned artifact ``artifacts/bench/calibration_cuda.json``, which the
port's simulator side loads (``InterferenceModel.from_artifact``,
``perf_params_from_artifact``). The reference's ``calibration.json`` is
never written here.

    python -m repro_torch.launch.calibrate                  # the card
    python -m repro_torch.launch.calibrate --reduced --device cpu --iters 1

Full width by default (bf16, seq 2048, B = 4); ``--reduced`` takes the
reduced configs in f32 at seq 64, as the reference's benchmark does.
``--pairs cross`` measures only the pairs of two different archs,
``all`` every unordered pair, self-pairs included. The default is
``cross`` at full width and ``all`` with ``--reduced``: a full-width
minicpm-2b with itself (two states of 27.3 GB and one step's
transients, ~82 GB) does not fit an 80 GB card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.calibration import run_calibration, save_artifact
from repro_torch.launch.cluster import JobSpec

ARCHS = ("minicpm-2b", "qwen2-vl-2b")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ARTIFACTS = os.path.join(ROOT, "artifacts", "bench")
CALIBRATION_PATH = os.path.join(ARTIFACTS, "calibration_cuda.json")


def build_specs(archs=ARCHS, *, batch: int = 4, seq: int = 2048,
                reduced: bool = False, depth_fraction: float = 1.0):
    """One JobSpec per arch, seeds 0, 1, ... in ``archs`` order. Full
    width in the config's dtype, or ``reduced`` configs in f32.
    ``depth_fraction`` < 1 keeps that share of the layers (whole pattern
    units); the config's name then says how many, e.g. ``minicpm-2b@20``."""
    specs = {}
    for i, name in enumerate(archs):
        cfg = get_config(name)
        if reduced:
            cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        if depth_fraction != 1.0:
            u = cfg.pattern_unit()
            n = max(u, round(cfg.n_layers * depth_fraction / u) * u)
            cfg = dataclasses.replace(cfg, name=f"{cfg.name}@{n}",
                                      n_layers=n)
        specs[name] = JobSpec(cfg, batch=batch, seq=seq, seed=i)
    return specs


def select_pairs(names, which: str):
    """``"all"``: every unordered pair incl. self-pairs (None, the
    pipeline's default); ``"cross"``: pairs of two different archs."""
    if which == "all":
        return None
    if which == "cross":
        names = sorted(names)
        return [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    raise ValueError(f"unknown pair selection {which!r}")


def peak_memory() -> str:
    """``", peak <GB> GB"`` of the card's allocator, or "" on the CPU."""
    import torch
    if not torch.cuda.is_initialized():
        return ""
    return f", peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"


def report(payload) -> None:
    for key, entry in payload["pairs"].items():
        print(f"{key}: measured xi=({entry['xi_a']:.3f},"
              f"{entry['xi_b']:.3f}) structural="
              f"({entry['xi_a_structural']:.3f},"
              f"{entry['xi_b_structural']:.3f}) "
              f"[pair {entry['t_pair']:.4f}s/step]")
    for name, entry in payload["archs"].items():
        print(f"{name} ({entry['arch']}): t_comp(b) ~= "
              f"{entry['alpha_comp']:.5f} + {entry['beta_comp']:.5f}*b "
              f"(sweep over {entry['sweep']['sub_batches']}: "
              f"{entry['sweep']['times']})")
    print(f"host: {payload['host']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", nargs="+", default=list(ARCHS),
                    choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--pairs", default=None, choices=("all", "cross"),
                    help="default: cross at full width, all with --reduced")
    args = ap.parse_args(argv)
    if args.pairs is None:
        args.pairs = "all" if args.reduced else "cross"
    t0 = time.perf_counter()
    specs = build_specs(args.arch, reduced=args.reduced,
                        seq=64 if args.reduced else 2048)
    payload = run_calibration(specs, iters=args.iters,
                              pairs=select_pairs(specs, args.pairs),
                              device=args.device)
    save_artifact(payload, CALIBRATION_PATH)
    report(payload)
    print(f"calibration artifact -> {CALIBRATION_PATH}")
    print(f"{time.perf_counter() - t0:.1f} s{peak_memory()}")
    return payload


if __name__ == "__main__":
    main()
