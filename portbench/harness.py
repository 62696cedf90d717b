"""One run of one cell: set-up, the measured window, the traced
window's per-layer metrics, the check against the reference, and the
result line.

Everything a cell is made of is data, found by name: the cell in
``BENCHMARK.json``, its configuration's file, its traffic mix in
``portbench/traffic/<traffic>.json`` (the jobs: configuration, batch B,
sequence S, sub-batch b; a co-tenant's configuration inline), the limits
of its check in ``portbench/limits/<cell>.json``, each family's FLOP
arithmetic in ``portbench/families/<family>.py`` and its plain reference
in ``portbench/reference/<family>.py``, and each per-layer metric's
reader in ``portbench/metrics/<metric>.py``.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

import torch

from . import check, data
from .reference import train as reference

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TOP_OPS = 10


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _read(root: str, *parts) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def check_config(conf: dict) -> None:
    """Each field the configuration's ``run`` block shares with its
    source has the source's value."""
    for field, key in conf.get("same_as_source", {}).items():
        if conf["run"][field] != conf[key]:
            raise ValueError(f"{conf['name']}: run.{field} = "
                             f"{conf['run'][field]!r} but {key} = "
                             f"{conf[key]!r}")


def load_cell(root: str, name: str) -> dict:
    bench = _read(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = _read(root, entry["file"])
    traffic = _read(root, "portbench", "traffic", f"{cell['traffic']}.json")
    jobs = []
    for i, j in enumerate(traffic["jobs"]):
        conf = config if j["config"] == "cell" else j["config"]
        check_config(conf)
        run = conf["run"]
        jobs.append({
            "name": conf["name"] if j["name"] == "cell" else j["name"],
            "index": i, "run": run, "batch": j["batch"], "seq": j["seq"],
            "sub_batch": j["sub_batch"],
            "family": importlib.import_module(
                f"{__package__}.families.{run['family']}")})
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    return {"name": name, "chips": cell["chips"], "jobs": jobs,
            "traffic": traffic, "end_to_end": bench["end_to_end"],
            "per_layer": per_layer}


def metric_reader(root: str, name: str):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Window:
    """What the readers of the per-layer metrics are given."""

    def __init__(self, jobs, walls, seconds):
        self.jobs = jobs
        self.walls = walls              # step_group's walltime of each step
        self.seconds = seconds          # host seconds of the window
        self.tokens = {j["name"]: len(walls) * j["batch"] * j["seq"]
                       for j in jobs}
        self.device = []                # (start ns, end ns, name)
        self.host = []
        self.span = None                # the window's (start ns, end ns)
        self.totals = {}                # trace_totals of the device

    def device_in_window(self):
        lo, hi = self.span
        return [(s, e, n) for s, e, n in self.device if e > lo and s < hi]


def _gc_timer(pauses: list):
    """A ``gc.callbacks`` entry that appends each collection's seconds."""
    t = [0.0]

    def timer(phase, info):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            pauses.append(time.perf_counter() - t[0])
    return timer


def _allocator() -> dict:
    """Counters of the card's caching allocator the window may move."""
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc",
                                      "num_device_free",
                                      "reserved_bytes.all.peak")}


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             *, device="cuda", t0=None) -> tuple:
    """(result dict or None, exit code)."""
    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    cell = load_cell(root, name)
    traffic, jobs = cell["traffic"], cell["jobs"]
    from . import program
    want = traffic["optimizer"]
    have = program.optimizer_settings()
    if any(abs(have[k] - want[k]) > 1e-12 * abs(want[k]) for k in want):
        raise ValueError(f"the port trains with {have}, the traffic file "
                         f"states {want}")
    n_checked = traffic["checked_steps"]
    count = max(traffic["batches"], n_checked + 1)

    # ---- set-up: weights, state, batches, the executor, one step ----- #
    t_made = time.perf_counter()
    if cuda:
        torch.zeros(1, device=device)   # the CUDA context, timed apart
        torch.cuda.synchronize()
    t_ctx = time.perf_counter()
    ex = program.Jobs(device)
    pools = {}
    for j in jobs:
        cfg = program.port_config(j["run"])
        j["layout"] = program.layout(cfg)
        params = data.make_weights(j["layout"], data.job_seed(seed, j["index"], 0),
                                   device)
        pools[j["name"]] = data.make_batches(
            j["run"], j["batch"], j["seq"], count,
            data.job_seed(seed, j["index"], 1), device)
        ex.start(j["name"], cfg, batch=j["batch"], seq=j["seq"],
                 sub_batch=j["sub_batch"], params=params,
                 first_batch=pools[j["name"]][0],
                 moments_dtype=torch.float32)
        del params
    t_step = time.perf_counter()
    _, first = ex.step()
    _sync(cuda)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s (imports {t_made - t0:.3f}, CUDA context "
        f"{t_ctx - t_made:.3f}, jobs {t_step - t_ctx:.3f}, first group step "
        f"{t0 + setup_s - t_step:.3f}); accumulation "
        f"{[ex.accum_steps(j['name']) for j in jobs]}")

    # ---- the check's readings of the program's first steps ------------ #
    prog = {}
    b1 = traffic["optimizer"]["b1"]
    for j in jobs:
        m = reference.leaves(ex.first_moments(j["name"]), j["family"].LAYERED)
        prog[j["name"]] = {
            "losses": [first[j["name"]]],
            "grad": {k: n / (1 - b1) for k, n in
                     reference.leaf_norms(m).items()}}
    for k in range(1, n_checked):
        for j in jobs:
            ex.feed(j["name"], pools[j["name"]][k])
        _, losses = ex.step()
        for j in jobs:
            prog[j["name"]]["losses"].append(losses[j["name"]])
    after = {j["name"]: {k: t.detach().to("cpu", copy=True) for k, t in
                         reference.leaves(ex.params(j["name"]),
                                          j["family"].LAYERED).items()}
             for j in jobs}
    checked = {j["name"]: [{k: t.to("cpu", copy=True) for k, t in b.items()}
                           for b in pools[j["name"]][:n_checked]]
               for j in jobs}

    # ---- the window ------------------------------------------------------ #
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
        span = record_function("portbench.window")
        span.__enter__()
    walls, attempted, failed, k = [], 0, 0, n_checked
    pauses = []
    gc.callbacks.append(_gc_timer(pauses))
    alloc0 = _allocator() if cuda else {}
    _sync(cuda)
    t_start = time.perf_counter()
    while True:
        for j in jobs:
            ex.feed(j["name"], pools[j["name"]][k % count])
        if prof is not None:
            with record_function("portbench.step_group"):
                wall, losses = ex.step()
        else:
            wall, losses = ex.step()
        walls.append(wall)
        attempted += len(jobs)
        failed += sum(not math.isfinite(v) for v in losses.values()) + \
            len(jobs) - len(losses)
        k += 1
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    gc.callbacks.pop()
    if prof is not None:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    alloc = {k: v - alloc0.get(k, 0) for k, v in
             (_allocator() if cuda else {}).items()}
    log(f"window {window_s:.3f} s, {len(walls)} group steps "
        f"{[round(w, 4) for w in walls]}; gc pauses "
        f"{len(pauses)} ({sum(pauses):.3f} s); allocator in the window "
        f"{alloc}")

    win = Window(jobs, walls, window_s)
    metrics, breakdown, device_info = {}, None, {}
    if not trace:
        total = sum(win.tokens.values())
        values = {"train_tokens_per_s": total / window_s,
                  "peak_mem_gib": None if peak is None else peak / 2 ** 30,
                  "setup_s": setup_s}
        for m in cell["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        breakdown, device_info = read_trace(prof, win, cuda)
        del prof
        for m in cell["per_layer"]:
            value = metric_reader(root, m["name"]).read(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # ---- the check: free the program, then the reference --------------- #
    ex.close()
    del ex, pools
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = {}
    for j in jobs:
        t_ref = time.perf_counter()
        p0 = data.make_weights(j["layout"], data.job_seed(seed, j["index"], 0),
                               device)
        base = reference.leaves(p0, j["family"].LAYERED)
        prog[j["name"]]["change"] = {
            k: float(torch.linalg.vector_norm(
                after[j["name"]][k].to(device).float() - t.float()))
            for k, t in base.items()}
        del base
        after[j["name"]] = None
        batches = [{k: t.to(device) for k, t in b.items()}
                   for b in checked[j["name"]]]
        ref = reference.train(p0, j["run"], batches, traffic["optimizer"],
                              layered=j["family"].LAYERED)
        del p0, batches
        readings[j["name"]] = check.gaps(prog[j["name"]], ref)
        log(f"reference of {j['name']}: {time.perf_counter() - t_ref:.1f} s; "
            f"losses program {prog[j['name']]['losses']} reference "
            f"{ref['losses']}; worst leaves "
            f"{check.worst(prog[j['name']], ref)}")
        del ref
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    correct, checks = check.judge(readings, check.load_limits(root, name))
    correct = correct and failed == 0

    # after everything that decides the result, the reference included
    bad = forbidden_modules()
    if bad:
        log(f"modules that may not be loaded were loaded: {bad}")
        return None, 3

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda
                         else "cpu",
                         "count": cell["chips"],
                         "memory_peak_bytes": peak, **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, 0


def read_trace(prof, win: Window, cuda: bool) -> tuple:
    """Fills ``win`` from the profile; returns (breakdown, the device
    block's busy_s and window_s)."""
    from torch.autograd import DeviceType
    from .yardstick import trace as yt
    t_read = time.perf_counter()
    win.device, win.host, notes = yt.raw_events(prof)
    spans = [(s, e) for s, e, n in win.host if n == "portbench.window"]
    win.span = spans[0]
    lo, hi = win.span
    if cuda:
        win.totals = {k: v for k, v in
                      yt.trace_totals(prof, DeviceType.CUDA).items()
                      if k not in notes}
    segments = yt.busy_segments(win.device, lo, hi)
    busy_s = sum(e - s for s, e in segments) / 1e9
    gaps = sorted(yt.idle_gaps(segments, lo, hi),
                  key=lambda g: g[1] - g[0], reverse=True)[:TOP_OPS]
    top = sorted(win.totals.items(), key=lambda kv: kv[1][0],
                 reverse=True)[:TOP_OPS]
    breakdown = {
        "device_ops": [[key[:160], us / 1e6] for key, (us, _) in top],
        "idle_gaps": [[yt.host_activity(win.host, g)[:160],
                       (g[1] - g[0]) / 1e9] for g in gaps]}
    log(f"trace read in {time.perf_counter() - t_read:.1f} s: "
        f"{len(win.device)} device and {len(win.host)} host events")
    return breakdown, {"busy_s": busy_s, "window_s": (hi - lo) / 1e9}


def main(root: str, args, t0: float) -> int:
    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the card")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    result, code = run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda", t0=t0)
    if result is None:
        return code
    for key, c in result["checks"].items():
        log(f"check {key} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return code
