"""Quickstart (the reference's ``examples/quickstart.py``): train a
~100M-parameter dense LM for a few hundred steps on structured synthetic
data with gradient accumulation, the paper's convergence-preserving
memory mechanism, and check that the loss goes down.

    python -m repro_torch.launch.quickstart [--steps 200] [--device cpu]

The model is minicpm-2b shrunk to 8 layers, d_model 768, 12 heads of 64,
d_ff 2048 and a 32768-token vocabulary, in f32. On the card attention
takes the flash kernels (their f32 versions).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.models import init_params, param_count
from repro_torch.train import TrainConfig, wsd_schedule


def shrunk_config():
    """minicpm-2b at ~100M parameters, as the reference's quickstart."""
    return dataclasses.replace(
        get_config("minicpm-2b"), n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=12, head_dim=64, d_ff=2048, vocab=32768,
        dtype="float32")


def run(cfg, *, steps: int, batch: int, seq: int, accum_steps: int,
        device=None) -> List[float]:
    """Train ``cfg`` from seed 0 on structured batches under the
    quickstart's WSD schedule; returns the per-step losses."""
    dev = resolve_device(device)
    params = init_params(cfg, 0, device=dev)
    print(f"model: {cfg.name} shrunk to {param_count(params):,} params "
          f"on {dev}")
    sched = wsd_schedule(peak_lr=6e-4, warmup_steps=20,
                         stable_steps=int(steps * 0.7),
                         decay_steps=int(steps * 0.25))
    tc = TrainConfig(accum_steps=accum_steps, schedule=sched)
    data = SyntheticLM(cfg, batch=batch, seq=seq, structured=True,
                       device=dev)
    _, _, losses = train_loop(cfg, params, data, tc, steps, log_every=20)
    return losses


def check_falls(losses: List[float]) -> tuple:
    """(first-10 mean, last-10 mean); raises if the loss did not fall."""
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    print(f"loss: first-10 avg {first:.4f} -> last-10 avg {last:.4f}")
    if not last < first:
        raise RuntimeError("training did not reduce the loss")
    print("OK: loss decreased.")
    return first, last


def main(argv: Optional[List[str]] = None) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--accum-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    losses = run(shrunk_config(), steps=args.steps, batch=args.batch,
                 seq=args.seq, accum_steps=args.accum_steps,
                 device=args.device)
    return check_falls(losses)


if __name__ == "__main__":
    main()
