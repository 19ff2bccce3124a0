"""Utilities: experiment logging, step timing."""

from .logging import ExperimentLogger  # noqa: F401
from .profiling import StepTimer, profiler_trace, time_fn  # noqa: F401
