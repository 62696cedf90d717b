from .synthetic import make_batch

__all__ = ["make_batch"]
