"""Autotuning entry point of the port (the twin of the reference's
``benchmarks/autotune_sweep.py``): sweep every kernel's run-time knob over
the port's shape classes on the card (``kernels/autotune.py``), write the
versioned table that ``kernels/ops.py`` consults,
``artifacts/bench/autotune_cuda.json``, and the full sweep record
``BENCH_autotune_cuda.json`` beside it (every candidate's time, the plain
version's ``t_ref``, the library call's ``t_lib`` and each class's
``speedup_vs_default``). Prints one line per class. The reference's
``autotune.json`` is never written here.

    python -m repro_torch.launch.autotune                 # the card
    python -m repro_torch.launch.autotune --smoke --device cpu

On the CPU every candidate times the plain version and the table says
``backend: "cpu"``, so ``ops`` never uses it on the card. Writing a table
installs it nowhere: a process routes by it only after
``autotune.reset_table(path)`` (or ``set_table``).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from repro_torch.kernels import autotune

BENCH_NAME = "BENCH_autotune_cuda.json"


def _fmt(t) -> str:
    return "-" if t is None else f"{t * 1e3:.4f}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="a few small classes (the CPU tests' size)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed calls per candidate (default 10; smoke 2)")
    ap.add_argument("--out", default=autotune.DEFAULT_PATH,
                    help="the table; the sweep record goes beside it")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    table, bench = autotune.run_autotune(smoke=args.smoke, iters=args.iters,
                                         device=args.device)
    path = autotune.save_artifact(table, args.out)
    bench_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                              BENCH_NAME)
    with open(bench_path, "w") as f:
        json.dump(bench, f, indent=1)
    for key, e in table["entries"].items():
        knobs = {k: v for k, v in e.items()
                 if k not in ("backend", "speedup_vs_default")
                 and not k.startswith("t_")}
        print(f"{key}: {json.dumps(knobs)} best {_fmt(e['t_best'])} ms, "
              f"default {_fmt(e['t_default'])} ms, plain "
              f"{_fmt(e['t_ref'])} ms, library {_fmt(e['t_lib'])} ms, "
              f"x{e['speedup_vs_default']:.3f} vs default")
    meta = table["meta"]
    print(json.dumps({"table": path, "bench": bench_path,
                      "backend": meta["backend"], "card": meta["card"],
                      "decode_splits": bench["decode_splits"],
                      "seconds": meta["seconds"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
