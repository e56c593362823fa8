"""Resilience primitives the serving path uses: circuit breaking,
transient retry and deterministic fault injection."""
from .circuit import CircuitBreaker
from .faults import FaultPlan, fault_point
from .retry import RetryPolicy, mark_warm

__all__ = ["CircuitBreaker", "RetryPolicy", "mark_warm", "FaultPlan",
           "fault_point"]
