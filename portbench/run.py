"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on NVIDIA
GPUs: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line, the run's result, as the last line of standard
output, and the numbers of the check, each beside its limit, as the last
lines of standard error. Exits 2 without a card (or with fewer than the
cell asks for), or where the checkout has no ``src/repro_torch``; exits 3
where the run loaded ``jax``, ``jaxlib``, ``flax`` or ``repro``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "_portbench_cache")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("[portbench] no src/repro_torch beside the benchmark: "
              "nothing to measure", file=sys.stderr)
        return 2
    # the program's caches inside the checkout, at fixed paths; no
    # library the port uses may load JAX on its own
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench import harness
    return harness.main(ROOT, args, T0)


if __name__ == "__main__":
    sys.exit(main())
