from .model import (decode_step, forward, init_cache, init_paged_cache,
                    init_params, param_count, prefill, prefill_extend)

__all__ = ["decode_step", "forward", "init_cache", "init_paged_cache",
           "init_params", "param_count", "prefill", "prefill_extend"]
