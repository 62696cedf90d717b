"""The Mamba2 SSD kernels' share of their roofline: over every launch of
the four passes in the window (forward state and chunk, backward state
and chunk), the sum of each pass's least time on the H100 at the cell's
SSD shape (``ssd_bounds``, frozen from chip_smoke.py; the TF32 bound,
``bound_tf32_ms``: the f32 products at the TF32 tensor-core peak or the
bytes, whichever is longer, which no f32-accurate route can beat) over
the sum of their device time, in percent. Reads nothing where no job
of the cell runs the SSD, or where two run it at different shapes.
Layer: kernels. Moves ``train_tokens_per_s``."""
from portbench.families import micro_rows
from portbench.yardstick.bounds import ssd_bounds

LAYER = "kernels"
UNIT = "%"
MOVES = "train_tokens_per_s"
PASSES = {"ssd_fwd_state_kernel": "fwd_state",
          "ssd_fwd_chunk_kernel": "fwd_chunk",
          "ssd_bwd_state_kernel": "bwd_state",
          "ssd_bwd_chunk_kernel": "bwd_chunk"}


def read(win):
    calls = []
    for j in win.jobs:
        micro = micro_rows(j["batch"], j["sub_batch"])
        calls += j["family"].ssd_launches(j["run"], micro, j["seq"])
    if not calls or any(c["shape"] != calls[0]["shape"] for c in calls):
        return None
    bounds = ssd_bounds(calls[0]["shape"], calls[0]["dtype"])
    bound_ms = time_ns = 0.0
    for s, e, name in win.device_in_window():
        for kernel, part in PASSES.items():
            if kernel in name:
                bound_ms += bounds[part]["bound_tf32_ms"]
                time_ns += e - s
                break
    if not time_ns:
        return None
    return 100.0 * bound_ms * 1e6 / time_ns
