"""The garbage collector's stalls: the share of the traced window in
which the device is idle while the host is inside a ``repro_torch.gc``
span (the port's ``gc.callbacks`` entry, one span a collection), in
percent. Reads nothing where the window holds no ``repro_torch.gc`` span:
a window of whole training steps always collects, so no span means the
program opens none. Layer: executor (the host process that steps the
jobs). Moves ``train_tokens_per_s``."""
from portbench.yardstick.trace import busy_segments

LAYER = "executor"
UNIT = "%"
MOVES = "train_tokens_per_s"
GC = "repro_torch.gc"


def _covered(rows, lo, hi) -> int:
    return sum(e - s for s, e in busy_segments(rows, lo, hi))


def read(win):
    """The device's busy time with the collections' spans added, less
    its busy time alone: the time a collection ran while it idled."""
    lo, hi = win.span
    gc = [row for row in win.host if row[2] == GC and row[0] < hi
          and row[1] > lo]
    if not gc:
        return None
    stalled = (_covered(sorted(win.device + gc), lo, hi)
               - _covered(win.device, lo, hi))
    return 100.0 * stalled / (hi - lo)
