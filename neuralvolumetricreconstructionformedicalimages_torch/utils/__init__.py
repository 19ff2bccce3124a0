"""Utilities: experiment logging, step timing."""

from .logging import ExperimentLogger  # noqa: F401
from .profiling import StepTimer, time_fn  # noqa: F401
