"""What zamba2-7b's causal conv adds to the dry-run's collective bytes.

    PYTHONPATH=src python dryrun_conv_bytes.py [--shape prefill_32k]
        [--multi-pod] [--out PATH]

Traces the zamba2-7b record of each ``--shape`` (default prefill_32k and
train_4k) on the fake 16 x 16 mesh (2 x 16 x 16 with ``--multi-pod``)
through ``launch.dryrun.trace``, with ``models.ssm._causal_conv``
wrapped: each call on DTensors notes the placements its ``xbc`` arrives
with and the collectives counted while it runs (the redistribution of
its operands to the local blocks ``on_local_blocks`` asks for), and, in
a train step, those counted while autograd runs the call's backward:
from the gradient reaching its output to the gradient leaving its
``xbc`` (two identity functions mark them; autograd runs the nodes the
call made between the two). Prints one JSON object per record: the
placements seen, the calls traced, the forward's and the backward's
collective bytes by kind over those calls (a train step traces two of
its ``accum_steps`` micro-batches and counts the rest as copies of the
second, so a step's share is these bytes times ``accum_steps`` / 2),
beside the record's own collective bytes; ``--out`` writes the list.
Host only: no card is used.
"""
import argparse
import json
import os
import sys
from collections import Counter

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import ssm
    from repro_torch.sharding.hooks import is_dtensor

    counters = []
    enter = dryrun.OpCounter.__enter__

    def enter_and_keep(self):
        counters.append(self)
        return enter(self)

    calls, backward = [], Counter()
    conv = ssm._causal_conv

    def collectives(ops) -> Counter:
        coll = Counter()
        for key, n in ops.items():
            if key[3]:                       # (op, flops, bytes, kind, cb)
                coll[key[3]] += key[4] * n
        return coll

    class Mark(torch.autograd.Function):
        """The identity; its backward calls ``at``."""

        @staticmethod
        def forward(ctx, x, at):
            ctx.at = at
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            ctx.at()
            return g, None

    def conv_noted(xbc, w, b, window=None):
        if not is_dtensor(xbc) or not counters:
            return conv(xbc, w, b, window)
        counter = counters[-1]
        seen = {}

        def grad_out():
            seen["ops"] = Counter(counter._frames[-1].ops)

        def grad_in():
            if "ops" in seen:
                backward.update(collectives(counter._frames[-1].ops
                                            - seen.pop("ops")))

        grad = torch.is_grad_enabled() and xbc.requires_grad
        if grad:
            xbc = Mark.apply(xbc, grad_in)
        frame = counter._frames[-1]
        before = Counter(frame.ops)
        out = conv(xbc, w, b, window)
        calls.append({"xbc": [str(p) for p in xbc.placements],
                      "w": [str(p) for p in w.placements]
                      if is_dtensor(w) else "plain",
                      "collective_bytes": dict(collectives(frame.ops
                                                           - before))})
        return Mark.apply(out, grad_out) if grad else out

    dryrun.OpCounter.__enter__ = enter_and_keep
    ssm._causal_conv = conv_noted
    shapes = args.shape or ["prefill_32k", "train_4k"]
    mp = args.multi_pod
    label = dryrun.mesh_name(mp)
    rows = []
    with dryrun.fake_world(512 if mp else 256):
        mesh = dryrun.fake_mesh((2, 16, 16) if mp else (16, 16),
                                ("pod", "data", "model") if mp
                                else ("data", "model"))
        for shape in shapes:
            calls.clear()
            backward.clear()
            rec = dryrun.trace("zamba2-7b", shape, mesh, mesh_label=label)
            total = Counter()
            for c in calls:
                total.update(c["collective_bytes"])
            row = {"arch": "zamba2-7b", "shape": shape, "mesh": label,
                   "torch": torch.__version__, "status": rec["status"],
                   "calls_traced": len(calls),
                   "xbc_placements": sorted({" ".join(c["xbc"])
                                             for c in calls}),
                   "w_placements": sorted({" ".join(c["w"])
                                           if c["w"] != "plain" else "plain"
                                           for c in calls}),
                   "conv_forward_collective_bytes_a_call":
                       calls[0]["collective_bytes"] if calls else {},
                   "calls_alike": all(c == calls[0] for c in calls),
                   "conv_forward_collective_bytes": dict(total),
                   "conv_backward_collective_bytes": dict(backward),
                   "record_collective_bytes":
                       rec.get("collective_bytes_per_device"),
                   "accum_steps": rec.get("accum_steps"),
                   "loop_trips_not_run": rec.get("loop_trips_not_run")}
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
