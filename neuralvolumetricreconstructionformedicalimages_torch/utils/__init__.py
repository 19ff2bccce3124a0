"""Utilities: experiment logging, step timing."""

from .logging import ExperimentLogger  # noqa: F401
from .profiling import StepTimer, cuda_time_ms  # noqa: F401
