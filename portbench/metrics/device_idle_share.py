"""The device's idle share of the window: one minus the union of the
intervals of its operations (kernels, copies, fills) inside the traced
window, over the window's length, in percent. Layer: device. Moves
``train_tokens_per_s``."""
from portbench.yardstick.trace import busy_segments

LAYER = "device"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(win):
    lo, hi = win.span
    busy = sum(e - s for s, e in busy_segments(win.device, lo, hi))
    if not busy:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
