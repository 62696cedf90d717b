"""The flash-attention kernels' share of their roofline: over every
forward, dQ and dK/dV launch in the window, the sum of each launch's
least time on the H100 (``attention_bounds``, frozen from chip_smoke.py,
at the launch's shape) over the sum of their device time, in percent.

A launch's kind and head size come from its kernel's name (the names
below, templated on D); its shape from the cell's jobs, whose attention
at that head size has one shape. Where two jobs of a cell attend at one
head size with different shapes, or no launch is found, it reads
nothing. Layer: kernels. Moves ``train_tokens_per_s``."""
import re

from portbench.families import micro_rows
from portbench.yardstick.bounds import attention_bounds

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tokens_per_s"
KINDS = (("flash_bwd_dkdv", "flash_bwd_dkdv"), ("flash_bwd_dq", "flash_bwd_dq"),
         ("flash_fwd_", "flash_fwd"))
TEMPLATE = re.compile(r"<([^<>]*)>")


def kind_and_head_dim(name: str):
    for part, kind in KINDS:
        if part in name:
            args = TEMPLATE.search(name)
            return kind, int(args.group(1).split(",")[-1])
    return None


def read(win):
    shapes = {}
    for j in win.jobs:
        micro = micro_rows(j["batch"], j["sub_batch"])
        for call in j["family"].attention_launches(j["run"], micro, j["seq"]):
            key = call["shape"][3]
            if shapes.setdefault(key, call) is not call and \
                    shapes[key]["shape"] != call["shape"]:
                return None
    bound_ms = time_ns = 0.0
    bounds = {}
    for s, e, name in win.device_in_window():
        hit = kind_and_head_dim(name)
        if hit is None or hit[1] not in shapes:
            continue
        kind, d = hit
        if d not in bounds:
            c = shapes[d]
            bounds[d] = attention_bounds(c["shape"], c["dtype"], c["causal"],
                                         c["window"])
        bound_ms += bounds[d][kind]["bound_ms"]
        time_ns += e - s
    if not time_ns:
        return None
    return 100.0 * bound_ms * 1e6 / time_ns
