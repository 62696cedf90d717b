"""Reading a finished ``torch.profiler`` run: kernel totals by name and
category, the device's busy time, and the idle gaps by what the host was
doing.

``category`` and ``trace_totals`` are frozen copies of ``chip_smoke.py``
``_category`` (lines 2401-2411) and ``_trace_totals`` (lines 2414-2440)
at commit f024abf, with ``SSD_KERNELS`` (line 331) beside them. They read
the raw trace and give the sums ``key_averages()`` gives, without the
profiler's event tree. Later changes to the program do not change them.
"""
from __future__ import annotations

import bisect

# chip_smoke.py line 331 (f024abf)
SSD_KERNELS = ("ssd_fwd_state_kernel", "ssd_fwd_chunk_kernel",
               "ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel")

OTHER = "other (elementwise, reductions, copies)"


def category(kernel: str) -> str:
    """chip_smoke.py ``_category`` (lines 2401-2411, f024abf)."""
    if any(k in kernel for k in SSD_KERNELS):
        return "SSD (port kernels)"
    if "flash_decode_" in kernel:
        return "decode (port kernels)"
    if "flash_fwd_" in kernel or "flash_bwd_" in kernel:
        return "attention (port kernels)"
    low = kernel.lower()
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    return OTHER


def trace_totals(prof, device_type) -> dict:
    """chip_smoke.py ``_trace_totals`` (lines 2414-2440, f024abf).

    {event key: [us, count]} over a finished profile's events on
    ``device_type``, in the order of their first start: the sums
    ``key_averages()`` gives for those keys (an event's time is 0 when it
    is async; the same names, filter and order as the profiler's), read
    from the raw trace."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    rows = []
    for e in res.events():
        name = e.name()
        if (e.device_type() != device_type or _filter_name(name)
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        start, end = (e.start_ns() - t0) / 1000, (e.end_ns() - t0) / 1000
        timed = not (e.is_async() or e.start_thread_id() != e.end_thread_id())
        rows.append((start, -end, _rewrite_name(name, with_wildcard=True),
                     end - start if timed else 0))
    rows.sort(key=lambda r: r[:2])
    totals = {}
    for _, _, key, us in rows:
        tot = totals.setdefault(key, [0, 0])
        tot[0] += us
        tot[1] += 1
    return totals


def raw_events(prof):
    """(device events, host events, annotations): the first two lists of
    (start_ns, end_ns, name) from the raw trace, the device's kernels,
    copies and fills, and the host's operators, runtime calls and
    ``record_function`` spans; then the names of the spans' copies on
    the device's timeline (user annotations), which are no device work."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    device, host, notes = [], [], set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name):
            continue
        row = (e.start_ns(), e.end_ns(), name)
        if e.device_type() == DeviceType.CUDA:
            if (getattr(e, "is_user_annotation", lambda: False)()
                    or name.startswith("portbench.")):
                notes.add(name)
            else:
                device.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    device.sort()
    host.sort()
    return device, host, notes


def busy_segments(device, lo: int, hi: int):
    """The union of the device's event intervals, clipped to [lo, hi]
    (ns): a sorted list of disjoint (start, end)."""
    out = []
    for s, e, _ in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(seg) for seg in out]


def idle_gaps(segments, lo: int, hi: int):
    """The intervals of [lo, hi] that no busy segment covers."""
    gaps, at = [], lo
    for s, e in segments:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def host_activity(host, gap) -> str:
    """What the host was doing during ``gap``: the innermost host event
    (the shortest) that covers the gap's middle, or "host idle" where
    none does."""
    mid = (gap[0] + gap[1]) // 2
    i = bisect.bisect_right(host, (mid, float("inf"), ""))
    best = None
    # events are sorted by start; those starting after mid cannot cover it
    for s, e, name in host[:i]:
        if e >= mid and (best is None or e - s < best[0]):
            best = (e - s, name)
    return "host idle" if best is None else best[1]
