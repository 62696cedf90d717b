"""The model's elementwise work: device time of the operations that are
neither the port's kernels nor cuBLAS matrix products (``category``,
frozen from chip_smoke.py), over all device time, in percent. Layer:
model. Moves ``train_tokens_per_s``."""
from portbench.yardstick.trace import OTHER, category

LAYER = "model"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(win):
    total = sum(us for us, _ in win.totals.values())
    if not total:
        return None
    other = sum(us for key, (us, _) in win.totals.items()
                if category(key) == OTHER)
    return 100.0 * other / total
