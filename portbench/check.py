"""The comparison that decides ``correct``.

For every job of a cell, three numbers, each against the limit the cell's
limits file gives it:

* ``loss_gap``: the largest |program - reference| of the loss over the
  checked steps (nats);
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient, as its optimizer got it (m / (1 - b1) after
  step 1), and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf;
* ``change_gap``: the same of the norm of each leaf's change over the
  checked steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by round-off alone).
"""
from __future__ import annotations

import json
import math
import os
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
MOVED = 1e-3


def by_leaf(prog: dict, ref: dict) -> tuple:
    """({leaf: grad gap}, {moved leaf: change gap}) of one job."""
    g_ref = ref["grad"]
    med = statistics.median(g_ref.values())
    grad = {k: abs(prog["grad"][k] - g) / max(g, med)
            for k, g in g_ref.items()}
    moved = [k for k, g in g_ref.items() if g >= MOVED * med]
    d_med = statistics.median(ref["change"][k] for k in moved)
    change = {k: abs(prog["change"][k] - ref["change"][k])
              / max(ref["change"][k], d_med) for k in moved}
    return grad, change


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers of one job, from the program's and the
    reference's {"losses", "grad", "change"}."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program and the reference ran different "
                         "numbers of steps")
    loss = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    grad, change = by_leaf(prog, ref)
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}


def worst(prog: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` leaves with the largest gaps of each kind, for the log."""
    grad, change = by_leaf(prog, ref)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:n]  # noqa
    return {"grad": top(grad), "change": top(change)}


def load_limits(root: str, cell: str) -> dict:
    with open(os.path.join(root, "portbench", "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {"<job>.<number>": {"value", "limit"}}) over every job's
    numbers; a number that is not finite or over its limit fails. A
    limit of null is a number the cell reads but does not compare (no
    control or fault separates it from sound runs; PERF.md names it)."""
    checks, ok = {}, True
    for job, nums in readings.items():
        for name in NUMBERS:
            value, limit = nums[name], limits[job][name]
            checks[f"{job}.{name}"] = {"value": value, "limit": limit}
            if not math.isfinite(value) or (limit is not None
                                            and value > limit):
                ok = False
    return ok, checks
