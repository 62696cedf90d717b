"""The readings that set the upper end of each limit of a cell's check,
at the cell's own size: the control (the reference in the program's
place, computed with its products in float8, the precision below the
bf16 the configurations state) and the fault of half the batch left out
(the reference in the program's place, the mean taken over the first
half of each batch's rows), each compared with the f32 reference as the
program is. A state left unchanged reads 1 on ``grad_gap`` and
``change_gap`` by the measure itself and needs no run.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--kinds control,half_batch] [--jobs <job>,...]

Prints one JSON line a (job, seed, kind). Runs on the card (or, with
``--device cpu``, on the CPU at whatever size the cell has); the
benchmark's own runs never run it.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(root: str, workload: str, seeds, kinds, device, jobs=None,
             out=print):
    """{(job, seed, kind): the three numbers}, each also passed to
    ``out`` as a JSON line."""
    import torch
    from portbench import check, data, harness, program
    from portbench.reference import train as reference
    cell = harness.load_cell(root, workload)
    opt = cell["traffic"]["optimizer"]
    n = cell["traffic"]["checked_steps"]
    res = {}
    for j in cell["jobs"]:
        if jobs and j["name"] not in jobs:
            continue
        lay = program.layout(program.port_config(j["run"]))
        for seed in seeds:
            w = data.make_weights(lay, data.job_seed(seed, j["index"], 0),
                                  device)
            b = data.make_batches(j["run"], j["batch"], j["seq"], n,
                                  data.job_seed(seed, j["index"], 1), device)
            t = time.perf_counter()
            ref = reference.train(w, j["run"], b, opt,
                                  layered=j["family"].LAYERED)
            ref_s = time.perf_counter() - t
            for kind in kinds:
                t = time.perf_counter()
                if kind == "control":
                    got = reference.train(w, j["run"], b, opt, prec="fp8",
                                          layered=j["family"].LAYERED)
                elif kind == "half_batch":
                    got = reference.train(w, j["run"], b, opt,
                                          rows=range(j["batch"] // 2),
                                          layered=j["family"].LAYERED)
                else:
                    raise ValueError(f"unknown kind {kind!r}")
                g = check.gaps(got, ref)
                res[(j["name"], seed, kind)] = g
                out(json.dumps({"workload": workload, "job": j["name"],
                                "seed": seed, "kind": kind, **g,
                                "worst": check.worst(got, ref),
                                "reference_s": ref_s,
                                "seconds": time.perf_counter() - t}))
                del got
            del w, b, ref
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="control,half_batch")
    ap.add_argument("--jobs", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    readings(ROOT, args.workload, [int(s) for s in args.seeds.split(",")],
             args.kinds.split(","), args.device,
             jobs=[j for j in args.jobs.split(",") if j],
             out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
