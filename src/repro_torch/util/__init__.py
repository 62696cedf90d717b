"""Shared utilities of the port (standard library only)."""
from .errors import ArtifactVersionError
from .retry import RetryBudgetExceeded, RetryPolicy, retry_call

__all__ = ["ArtifactVersionError", "RetryBudgetExceeded", "RetryPolicy",
           "retry_call"]
