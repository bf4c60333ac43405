"""Runtime substrate: straggler detection, failure injection, metrics."""

from .monitor import FailureInjector, Metrics, StragglerMonitor

__all__ = ["StragglerMonitor", "FailureInjector", "Metrics"]
