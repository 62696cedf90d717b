"""End-to-end training driver (the reference's ``launch/train.py``):

    python -m repro_torch.launch.train --arch minicpm-2b --reduced --steps 200

trains a reduced or full-width architecture on synthetic LM data with
gradient accumulation, the WSD schedule and, with ``--checkpoint``, a
final checkpoint in the reference's npz format (``checkpoint.npz``). It
runs on the card unless ``--device cpu`` is given; attention takes the
flash kernels there.

``--distributed`` trains on the reference's FSDP('data') x TP('model')
plan: it takes the process group that ``torchrun`` started, or starts a
world of one itself (``nccl`` on the card, ``gloo`` with ``--device
cpu``, on a ``FileStore`` in a temporary directory, destroyed at the
end); builds the production mesh (16 x 16) on 256 ranks, else
``make_smoke_mesh`` over the world; distributes the parameters at their
sanitized placements (``launch.specs.param_shardings``) and each batch
over the batch axes; and runs the loop inside the activation rules, the
flash kernels on each rank's local block (``kernels.ops``). On the card
each rank takes the card of its ``LOCAL_RANK``. The checkpoint is
gathered whole and written by rank 0. For example, four CPU ranks:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --distributed --device cpu --reduced --steps 5
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Iterable, List, Optional, Tuple

import torch

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
    ap.add_argument("--distributed", action="store_true",
                    help="the production mesh and sharding rules over the "
                         "running process group (or a world of one)")
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


@contextlib.contextmanager
def process_group(device: torch.device):
    """The running process group, or a world of one started here on a
    ``FileStore`` in a temporary directory (``nccl`` on the card, ``gloo``
    on the CPU) and destroyed on exit. A start that fails raises."""
    import tempfile
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                **({"device_id": device}
                                   if device.type == "cuda" else {}))
        try:
            yield
        finally:
            dist.destroy_process_group()


def distributed_setup(cfg, params, device: torch.device):
    """(rules, DTensor params) on the mesh of the running group: the
    production mesh on 256 ranks, else ``make_smoke_mesh``."""
    import torch.distributed as dist
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
    from repro_torch.sharding.rules import distribute_tree, make_rules
    world = dist.get_world_size()
    mesh = make_production_mesh(device_type=device.type) if world == 256 \
        else make_smoke_mesh(world, device_type=device.type)
    rules = make_rules(mesh)
    return rules, distribute_tree(mesh, params,
                                  specs.param_shardings(rules, params))


def sharded_batches(data: Iterable, rules):
    """The batches of ``data``, each tensor distributed over the batch
    axes (``launch.specs.batch_shardings``)."""
    from repro_torch.launch import specs
    from repro_torch.sharding.rules import distribute_tree
    for batch in data:
        yield distribute_tree(rules.mesh, batch,
                              specs.batch_shardings(rules, batch))


@dataclasses.dataclass
class TrainRun:
    """What ``run`` leaves: the per-step losses, the final parameters
    and optimizer state (DTensors with ``--distributed``, whose group is
    gone by then), the mesh (or None) and the loop's seconds (ending
    with the losses read back from the device)."""

    losses: List[float]
    params: dict
    opt: OptState
    mesh: object
    loop_seconds: float


def run(argv: Optional[List[str]] = None) -> TrainRun:
    """The driver (see the module docstring) on ``argv``."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.distributed and dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
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
    if not args.distributed:
        t0 = time.perf_counter()
        params, opt, losses = train_loop(cfg, params, data, tc, args.steps,
                                         log_every=args.log_every)
        seconds = time.perf_counter() - t0
        if args.checkpoint:
            save(args.checkpoint, params=params, opt_state=opt,
                 step=args.steps)
            print(f"saved {args.checkpoint}")
        return TrainRun(losses, params, opt, None, seconds)

    import torch.distributed as dist
    from repro_torch.sharding.hooks import activation_rules
    from repro_torch.sharding.rules import full_tree
    with process_group(dev):
        rules, params = distributed_setup(cfg, params, dev)
        print(f"mesh={dict(zip(rules.mesh.mesh_dim_names, rules.mesh.shape))}"
              f" world={dist.get_world_size()}")
        t0 = time.perf_counter()
        with activation_rules(rules.activation_table(), rules=rules):
            params, opt, losses = train_loop(
                cfg, params, sharded_batches(data, rules), tc, args.steps,
                log_every=args.log_every)
        seconds = time.perf_counter() - t0
        if args.checkpoint:
            whole = full_tree(params)
            moments = OptState(step=opt.step, m=full_tree(opt.m),
                               v=full_tree(opt.v))
            if dist.get_rank() == 0:
                save(args.checkpoint, params=whole, opt_state=moments,
                     step=args.steps)
                print(f"saved {args.checkpoint}")
            del whole, moments
            dist.barrier()
    return TrainRun(losses, params, opt, rules.mesh, seconds)


def main(argv: Optional[List[str]] = None) -> float:
    """``run`` on ``argv``; returns the last step's loss."""
    return run(argv).losses[-1]


if __name__ == "__main__":
    main()
