"""The whole step's share of the card's peak: model FLOPs a token (each
family's frozen arithmetic, ``portbench/families``; recompute not
counted) times each job's tokens in the window, over the window's
seconds, as a percentage of 989 TFLOP/s, the H100's dense bf16 peak at
700 W. Layer: step. Moves ``train_tokens_per_s``."""
from portbench.yardstick.bounds import PEAK_FLOPS

LAYER = "step"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(win):
    if not win.seconds:
        return None
    flops = sum(j["family"].flops_per_token(j["run"], j["seq"])
                * win.tokens[j["name"]] for j in win.jobs)
    return 100.0 * flops / win.seconds / PEAK_FLOPS["bfloat16"]
