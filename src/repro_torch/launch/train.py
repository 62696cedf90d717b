"""End-to-end training driver (the reference's ``launch/train.py``):

    python -m repro_torch.launch.train --arch minicpm-2b --reduced --steps 200

trains a reduced or full-width architecture on synthetic LM data with
gradient accumulation, the WSD schedule and, with ``--checkpoint``, a
final checkpoint in the reference's npz format (``checkpoint.npz``). It
runs on the card unless ``--device cpu`` is given; attention takes the
flash kernels there. The reference's ``--distributed`` (its mesh and
sharding rules) is not ported, so argparse rejects it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Iterable, List, Optional, Tuple

from repro_torch.checkpoint import save
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import init_params, param_count
from repro_torch.train import (OptState, TrainConfig, adamw_init,
                               make_train_step, wsd_schedule)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="minicpm-2b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def train_loop(cfg, params, data: Iterable, tc: TrainConfig, steps: int, *,
               log_every: int = 10) -> Tuple[dict, OptState, List[float]]:
    """``steps`` AdamW steps of ``params`` (updated in place) on the
    batches of ``data``; returns (params, opt, per-step losses). Every
    ``log_every`` steps and at the last it prints the loss, the gradient
    norm and the mean seconds a step since the start. Only those prints
    wait for the device, as in the reference: the other steps' losses
    stay tensors until the loop ends."""
    opt = adamw_init(params)
    step = make_train_step(cfg, tc)
    losses = []
    t0 = time.perf_counter()
    for i, batch in zip(range(steps), data):
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].detach())
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d} loss {float(losses[-1]):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.3f}s/step)",
                  flush=True)
    return params, opt, [float(x) for x in losses]


def main(argv: Optional[List[str]] = None) -> float:
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype=args.dtype)

    sched = wsd_schedule(peak_lr=args.lr,
                         warmup_steps=max(args.steps // 20, 1),
                         stable_steps=int(args.steps * 0.7),
                         decay_steps=max(int(args.steps * 0.25), 1))
    tc = TrainConfig(accum_steps=args.accum_steps, schedule=sched)
    params = init_params(cfg, 0, device=dev)
    print(f"arch={cfg.name} params={param_count(params):,} "
          f"accum={args.accum_steps} device={dev}")
    data = SyntheticLM(cfg, args.batch, args.seq, device=dev)
    params, opt, losses = train_loop(cfg, params, data, tc, args.steps,
                                     log_every=args.log_every)
    if args.checkpoint:
        save(args.checkpoint, params=params, opt_state=opt, step=args.steps)
        print(f"saved {args.checkpoint}")
    return losses[-1]


if __name__ == "__main__":
    main()
