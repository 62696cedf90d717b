"""GPU sharing, for real (the twin of the reference's
``examples/shared_gpu_training.py``): co-schedule two training jobs on
one device, time-multiplexed inside one group step, measure the
interference ratios xi_A/xi_B, and let Theorem 1 decide whether the pair
should share or run sequentially.

The second job uses gradient accumulation (sub-batch b = B/s), the
paper's mechanism for fitting two jobs into one device's memory without
changing convergence.

    python -m repro_torch.launch.shared_gpu_training [--device cpu]

The jobs are minicpm-2b and qwen2-vl-2b at their reduced configs in
f32, B = 8 at seq 128, as the reference's example; on the card
attention takes the flash kernels (their f32 versions).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

from repro_torch.configs import get_config
from repro_torch.core.coschedule import JobSpec, measure_pair
from repro_torch.core.pair import PairJob, best_pair_schedule


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg_a = dataclasses.replace(get_config("minicpm-2b").reduced(),
                                dtype="float32")
    cfg_b = dataclasses.replace(get_config("qwen2-vl-2b").reduced(),
                                dtype="float32")
    # job B shrinks its per-step memory via gradient accumulation (s=4)
    spec_a = JobSpec(cfg_a, batch=args.batch, seq=args.seq, accum_steps=1,
                     seed=0)
    spec_b = JobSpec(cfg_b, batch=args.batch, seq=args.seq, accum_steps=4,
                     seed=1)

    print("measuring solo and interleaved step times (one group step)...")
    r = measure_pair(spec_a, spec_b, iters=args.iters, device=args.device)
    print(f"  t_A solo {r['t_a_solo']*1e3:7.1f} ms")
    print(f"  t_B solo {r['t_b_solo']*1e3:7.1f} ms (with grad accum s=4)")
    print(f"  t_pair   {r['t_pair']*1e3:7.1f} ms")
    print(f"  xi_A = {r['xi_a']:.2f}, xi_B = {r['xi_b']:.2f}")

    # Theorem 1: share or run sequentially? (A mid-flight, B arriving)
    a = PairJob(t_iter=r["t_a_solo"], iters=400, xi=r["xi_a"])
    b = PairJob(t_iter=r["t_b_solo"], iters=200, xi=r["xi_b"])
    dec = best_pair_schedule(a, b)
    mode = "SHARE now (kappa=0)" if dec.share else \
        f"run SEQUENTIALLY (kappa={dec.kappa:.1f}s)"
    print(f"Theorem 1 decision: {mode}; pair avg JCT {dec.avg_jct:.1f}s")
    seq_avg = 0.5 * (a.solo_time + (a.solo_time + b.solo_time))
    print(f"(sequential avg JCT would be {seq_avg:.1f}s)")
    return {"measurement": r, "decision": dec, "sequential_avg": seq_avg}


if __name__ == "__main__":
    main()
