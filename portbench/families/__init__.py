"""Each model family's FLOP arithmetic and kernel shapes, found by the
family's name (``portbench/families/<family>.py``)."""
import math


def micro_rows(batch: int, sub_batch: int) -> int:
    """Rows of a micro-batch when B is taken as s = ceil(B / b)
    micro-batches: ceil(B / s), as the port's gradient accumulation
    splits it."""
    steps = math.ceil(batch / min(sub_batch, batch))
    return math.ceil(batch / steps)
