"""A real multi-rank world on the CPU for ``test_torch_distributed.py``:

    python tests/_torch_dist_world.py --world 4 --out DIR

spawns ``--world`` ranks that join a ``gloo`` group over a ``FileStore``
under DIR, build ``make_smoke_mesh`` ((2, 2) for 4 ranks), and run every
case below on DTensors; rank 0 writes the results to DIR/results.pt
(plain tensors and floats). Each rank destroys its group when it ends.
Inputs are made from fixed seeds, the same as the test's single-process
runs.
"""
import argparse
import dataclasses
import os
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (arch, reshard_grads, grad_reduce_dtype) of the sharded training cases
TRAIN_CASES = (("minicpm-2b", False, None), ("minicpm-2b", True, None),
               ("qwen2-vl-2b", False, None), ("qwen2-vl-2b", True, None),
               ("minicpm-2b", True, "bfloat16"),
               ("zamba2-7b", False, None), ("xlstm-1.3b", False, None),
               ("llama4-maverick-400b-a17b", False, None))
BATCH, SEQ, ACCUM, STEPS = 4, 64, 2, 2
# the archs whose gradients of one micro-batch are held to the single
# process's, entry by entry: each runs code of its own on the local
# blocks (zamba2-7b's conv, xlstm-1.3b's mLSTM and sLSTM scans, the MoE
# experts of llama4-maverick)
GRAD_ARCHS = ("zamba2-7b", "xlstm-1.3b", "llama4-maverick-400b-a17b")


def reduced(arch: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def train_config(reshard, gdt):
    from repro_torch.train import TrainConfig
    return TrainConfig(accum_steps=ACCUM, reshard_grads=reshard,
                       grad_reduce_dtype=gdt)


def executor_specs():
    from repro_torch.launch.cluster import JobSpec
    return {"A": JobSpec(reduced("minicpm-2b"), batch=4, accum_steps=2,
                         seq=32, seed=1),
            "B": JobSpec(reduced("qwen2-vl-2b"), batch=4, accum_steps=2,
                         seq=32, seed=2)}


def op_inputs():
    """Inputs of each kernel wrapper, numpy-seeded: attention (B, S, H,
    D) with H 4 over 'model', decode with 2 kv heads, the SSD with 4
    heads."""
    rng = np.random.default_rng(7)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32))
    b, s, h, d = 4, 32, 4, 64
    att = {"q": r(b, s, h, d), "k": r(b, s, h, d), "v": r(b, s, h, d),
           "dout": r(b, s, h, d)}
    dec = {"q": r(b, 1, h, d), "k": r(b, 40, 2, d), "v": r(b, 40, 2, d),
           "lengths": torch.tensor([40, 3, 17, 1], dtype=torch.int32)}
    pool = 12
    pages = torch.from_numpy(rng.permutation(pool)[:8].reshape(4, 2)
                             .astype(np.int32))
    pages[3, 1] = -1
    paged = {"q": r(b, 1, h, d), "k": r(pool, 16, 2, d),
             "v": r(pool, 16, 2, d), "pages": pages,
             "lengths": torch.tensor([32, 20, 9, 16], dtype=torch.int32)}
    hs, p, n = 4, 64, 16
    ssd = {"x": r(b, s, hs, p), "dt": r(b, s, hs).abs() * 0.1 + 0.01,
           "A": -r(hs).abs() - 0.5, "Bm": r(b, s, n), "Cm": r(b, s, n),
           "state": r(b, hs, p, n) * 0.1, "dy": r(b, s, hs, p)}
    return att, dec, paged, ssd


def run_ops(mesh):
    """Each wrapper on DTensor inputs (replicated, redistributed by
    ``local_map``) against the same wrapper on the plain tensors; max
    |diff| of each output and gradient."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import ops

    def rep(t):
        return DTensor.from_local(t.clone(), mesh,
                                  [Replicate()] * mesh.ndim)

    def diff(a, b):
        if isinstance(a, DTensor):
            a = a.full_tensor()
        return float((a - b).detach().abs().max())

    att, dec, paged, ssd = op_inputs()
    out = {}
    # flash attention forward and backward
    plain = [att[k].clone().requires_grad_(True) for k in "qkv"]
    o = ops.flash_attention(*plain)
    grads = torch.autograd.grad(o, plain, att["dout"])
    dist_in = [rep(att[k]).requires_grad_(True) for k in "qkv"]
    od = ops.flash_attention(*dist_in)
    out["flash_attention_local"] = tuple(od.to_local().shape)
    dgrads = torch.autograd.grad(od, dist_in, rep(att["dout"]).redistribute(
        mesh, od.placements))
    out["flash_attention"] = max([diff(od, o)] + [
        diff(g, gp) for g, gp in zip(dgrads, grads)])
    out["flash_decode"] = diff(
        ops.flash_decode(rep(dec["q"]), rep(dec["k"]), rep(dec["v"]),
                         dec["lengths"]),
        ops.flash_decode(dec["q"], dec["k"], dec["v"], dec["lengths"]))
    out["flash_decode_paged"] = diff(
        ops.flash_decode_paged(rep(paged["q"]), rep(paged["k"]),
                               rep(paged["v"]), paged["pages"],
                               paged["lengths"]),
        ops.flash_decode_paged(paged["q"], paged["k"], paged["v"],
                               paged["pages"], paged["lengths"]))
    names = ("x", "dt", "A", "Bm", "Cm")
    plain = [ssd[k].clone().requires_grad_(True) for k in names]
    y = ops.ssd(*plain)
    grads = torch.autograd.grad(y, plain, ssd["dy"])
    dist_in = [rep(ssd[k]).requires_grad_(True) for k in names]
    yd = ops.ssd(*dist_in)
    dgrads = torch.autograd.grad(yd, dist_in, rep(ssd["dy"]).redistribute(
        mesh, yd.placements))
    out["ssd"] = max([diff(yd, y)] + [diff(g, gp)
                                      for g, gp in zip(dgrads, grads)])
    yp, st = ops.ssd_prefill(*(ssd[k] for k in names), ssd["state"])
    ypd, std = ops.ssd_prefill(*(rep(ssd[k]) for k in names),
                               rep(ssd["state"]))
    out["ssd_prefill"] = max(diff(ypd, yp), diff(std, st))
    return out


def run_blocks(mesh, rank: int, world: int):
    """Each rank's local block of an (8, 8) tensor under specs that put
    one tensor dim over two mesh axes, and one over each axis."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.rules import P, placements
    full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mine = {}
    for name, spec in (("data_model", P(("data", "model"), None)),
                       ("model_data", P(None, ("data", "model"))),
                       ("data", P("data", "model"))):
        t = distribute_tensor(full, mesh, placements(mesh, spec),
                              src_data_rank=None)
        mine[name] = t.to_local().clone()
    coords = [int(c) for c in mesh.get_coordinate()]
    got = [None] * world
    dist.all_gather_object(got, {"coords": coords, "blocks": mine})
    return got


def run_train(mesh, rules):
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import sharded_batches, train_loop
    from repro_torch.models import init_params
    from repro_torch.sharding.hooks import activation_rules
    from repro_torch.sharding.rules import distribute_tree, full_tree
    from repro_torch.launch import specs
    from repro_torch.tree import flatten
    out = {}
    for arch, reshard, gdt in TRAIN_CASES:
        cfg = reduced(arch)
        params = init_params(cfg, 0, device="cpu")
        params = distribute_tree(mesh, params,
                                 specs.param_shardings(rules, params))
        data = sharded_batches(SyntheticLM(cfg, BATCH, SEQ, device="cpu"),
                               rules)
        with activation_rules(rules.activation_table(), rules=rules):
            params, opt, losses = train_loop(
                cfg, params, data, train_config(reshard, gdt), STEPS,
                log_every=STEPS)
        want = flatten(specs.param_shardings(rules, params))
        out[f"{arch}|{reshard}|{gdt}"] = {
            "losses": losses, "params": full_tree(params),
            "placements": {k: (tuple(t.placements), tuple(want[k]))
                           for k, t in flatten(params).items()}}
    return out


def first_batch(cfg):
    from repro_torch.data import SyntheticLM
    return next(iter(SyntheticLM(cfg, BATCH, SEQ, device="cpu")))


def run_grads(mesh, rules):
    """Loss and gradients of one micro-batch (``make_loss_and_grad``) of
    each of ``GRAD_ARCHS`` on DTensors, the gradients gathered whole:
    {arch: (loss, [(key, index, gradient)])}."""
    from repro_torch.launch import specs
    from repro_torch.models import init_params
    from repro_torch.sharding.hooks import activation_rules
    from repro_torch.sharding.rules import distribute_tree
    from repro_torch.train import TrainConfig, make_loss_and_grad
    out = {}
    for arch in GRAD_ARCHS:
        cfg = reduced(arch)
        params = init_params(cfg, 0, device="cpu")
        params = distribute_tree(mesh, params,
                                 specs.param_shardings(rules, params))
        batch = first_batch(cfg)
        batch = distribute_tree(mesh, batch,
                                specs.batch_shardings(rules, batch))
        with activation_rules(rules.activation_table(), rules=rules):
            loss, grads = make_loss_and_grad(cfg, TrainConfig())(params,
                                                                 batch)
        out[arch] = (float(loss), [(k, i, g.full_tensor())
                                   for k, i, g in grads])
    return out


def run_executor(rules):
    from repro_torch.launch.cluster import ScheduleExecutor
    from repro_torch.sharding.rules import full_tree
    out = {}
    with ScheduleExecutor(device="cpu", rules=rules) as ex:
        for name, spec in executor_specs().items():
            ex.submit(name, spec, 2)
            ex.start(name)
        losses = [ex.step_group(["A", "B"])["losses"] for _ in range(2)]
        out["losses"] = losses
        out["params"] = {n: full_tree(ex.runs[n].params) for n in "AB"}
    return out


def worker(rank: int, world: int, out_dir: str) -> None:
    sys.path[:0] = [os.path.join(ROOT, "src")]
    torch.set_num_threads(1)
    import torch.distributed as dist
    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.sharding.rules import make_rules
        mesh = make_smoke_mesh(world, device_type="cpu")
        rules = make_rules(mesh)
        results = {"mesh": [int(s) for s in mesh.shape],
                   "blocks": run_blocks(mesh, rank, world),
                   "ops": run_ops(mesh),
                   "train": run_train(mesh, rules),
                   "grads": run_grads(mesh, rules),
                   "executor": run_executor(rules)}
        if rank == 0:
            torch.save(results, os.path.join(out_dir, "results.pt"))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    import torch.multiprocessing as mp
    mp.spawn(worker, args=(args.world, args.out), nprocs=args.world,
             join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
