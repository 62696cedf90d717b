"""Shared utilities of the port (standard library only)."""
from .errors import ArtifactVersionError

__all__ = ["ArtifactVersionError"]
