from .model import forward, init_params, param_count

__all__ = ["forward", "init_params", "param_count"]
