"""Shared utilities: profiling/tracing, compile cache."""

from .compilation_cache import enable_compilation_cache
from .profiling import Stopwatch, trace

__all__ = ["Stopwatch", "enable_compilation_cache", "trace"]
