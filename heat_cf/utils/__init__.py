from heat_cf.utils.profiling import PhaseTimer, performance_breakdown
from heat_cf.utils.logging import get_logger, MetricsLogger

__all__ = [
    "PhaseTimer",
    "performance_breakdown",
    "get_logger",
    "MetricsLogger",
]
