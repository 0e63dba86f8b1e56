"""Utilities: profiling scopes, op counters, runtime configuration."""

from .profiling import named_scope, OpCounter, profile_trace  # noqa: F401
from .config import config  # noqa: F401
