"""The executor's group step: the median of ``ScheduleExecutor.step_group``'s
own walltime (host clock between two synchronizes) over the window's
steps. Layer: executor. Moves ``train_tokens_per_s``."""
import statistics

LAYER = "executor"
UNIT = "s"
MOVES = "train_tokens_per_s"


def read(win):
    return statistics.median(win.walls) if win.walls else None
