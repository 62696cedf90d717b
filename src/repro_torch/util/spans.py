"""Spans at the port's layer boundaries, as ``torch.profiler`` ranges.

``with span("repro_torch.step.forward"): ...`` opens a
``record_function`` range only while a profiler records; otherwise it
is one shared no-op context, and the check costs one
``torch.autograd._profiler_enabled()`` call. The profiler is the only
switch: the ranges land in its trace beside the device's kernels, on its
clock, so a kernel or an idle gap of the device can be put down to what
the host was doing when it was launched.

The spans (names exact; ``chip_smoke.py`` ``_span_fields`` puts a
profiled step's device time down to them, and the benchmark's
``gc_idle_share`` reads the collector's):

    repro_torch.executor.step_group   one group step, both synchronizes
    repro_torch.step.micro_batch      one accumulated micro-batch
    repro_torch.step.forward          the loss: model forward and CE
    repro_torch.step.backward         its gradients (recompute included)
    repro_torch.step.accumulate       the accumulator: zero, add, scale
    repro_torch.step.optimizer        AdamW and the gradient norm
    repro_torch.model.unit            one unit's forward, again in the
                                      recompute under activation
                                      checkpointing
    repro_torch.kernels.attention     one flash-attention call (and
                  .attention_bwd      its backward)
    repro_torch.kernels.ssd           one SSD call (and its backward)
                  .ssd_bwd
    repro_torch.gc                    one collection of Python's garbage
                                      collector (``install_gc_spans``)
"""
from __future__ import annotations

import contextlib
import gc

import torch

NO_SPAN = contextlib.nullcontext()
GC = "repro_torch.gc"


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else the shared no-op ``NO_SPAN``."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return NO_SPAN


_open_gc = []


def _gc_span(phase: str, info) -> None:
    """A ``gc.callbacks`` entry: ``repro_torch.gc`` from a collection's
    start to its stop, while a profiler records."""
    if phase == "start":
        if torch.autograd._profiler_enabled():
            rf = torch.autograd.profiler.record_function(GC)
            rf.__enter__()
            _open_gc.append(rf)
    elif _open_gc:
        _open_gc.pop().__exit__(None, None, None)


def install_gc_spans() -> None:
    """Adds the garbage collector's span to ``gc.callbacks``, once per
    process."""
    if _gc_span not in gc.callbacks:
        gc.callbacks.append(_gc_span)
