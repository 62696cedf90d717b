"""Recompute the totals and roofline of existing dry-run records from
their kept op traces (``launch.dryrun --keep-trace``) without tracing
again, the reference's ``launch/reanalyze.py``: use it when the counting
conventions or the roofline constants change.

    python -m repro_torch.launch.reanalyze [PATH]

PATH defaults to ``artifacts/dryrun/dryrun_torch.json``, updated in
place. A record without a trace file is left as it is and named on
stderr.
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.launch.dryrun import (ARTIFACT_DIR, OUT_NAME, read_ops,
                                       roofline, totals)


def reanalyze(path: str) -> int:
    """Rewrite every ``ok`` record of ``path`` that has a trace; returns
    how many were rewritten."""
    with open(path) as f:
        records = json.load(f)
    n = 0
    for rec in records:
        if rec.get("status") != "ok":
            continue
        trace = rec.get("trace_path")
        if not trace or not os.path.exists(trace):
            print(f"no op trace for {rec['arch']} {rec['shape']} "
                  f"{rec['mesh']}; left as it is", file=sys.stderr)
            continue
        rec.update(totals(read_ops(trace)))
        rec["roofline"] = roofline(rec)
        n += 1
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    return n


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else os.path.join(ARTIFACT_DIR, OUT_NAME)
    print(f"re-analyzed {reanalyze(path)} records")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
