"""Loops whose trips repeat: ``scan``, the port's ``lax.scan``.

``carry, outs = scan(body, carry, n)`` runs ``carry, out = body(t,
carry)`` for t = 0 .. n-1 and returns the last carry and the n outs in
order, a plain Python loop over every trip, bit for bit the loop it
stands for. The model's and the trainer's repeating loops go through it
(the gradient-accumulation micro-batches, the sLSTM's tokens, the
mLSTM's chunks, the plain SSD's chunks forward and backward) so that
the dry-run can see them.

The dry-run's op counter (``launch.dryrun.OpCounter``) installs itself
here as the observer while it counts. ``scan`` then hands the loop to
its ``scan(body, carry, n, uniform=)``, which runs trips until two in a
row are identical, counts the trips that would repeat them from the
last one's ops instead of running them, and runs the final trip unless
the loop is ``uniform`` (the counterpart of the reference's
``hlo_flops``, which counts a ``while`` body once and multiplies it by
its trip count). Nothing else installs an observer, so
outside the dry-run every trip runs.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

_OBSERVER: Optional[Any] = None


def set_observer(observer) -> Optional[Any]:
    """Install ``observer`` (an object with ``scan(body, carry, n,
    uniform=)``, or None); returns the one it replaces."""
    global _OBSERVER
    prev, _OBSERVER = _OBSERVER, observer
    return prev


def scan(body: Callable[[int, Any], Tuple[Any, Any]], carry: Any,
         n: int, *, uniform: bool = False) -> Tuple[Any, List[Any]]:
    """(carry after the last trip, [out of trip 0, ..., out of trip
    n-1]) of ``carry, out = body(t, carry)`` for t in range(n).
    ``uniform``: the last trip is like the others (the same work on
    data of the same shapes, and no autograd graph from one trip to the
    next), so the dry-run need not run it."""
    if _OBSERVER is not None:
        return _OBSERVER.scan(body, carry, n, uniform=uniform)
    outs = []
    for t in range(n):
        carry, out = body(t, carry)
        outs.append(out)
    return carry, outs
