from .base import ARCH_NAMES, ArchConfig, get_config

__all__ = ["ARCH_NAMES", "ArchConfig", "get_config"]
