"""Serving layer: the resident multi-tenant counting service."""

from .counting_service import (  # noqa: F401
    CANCELLED,
    DEADLINE_EXCEEDED,
    SHED,
    TERMINAL_STATUSES,
    CountingService,
    PlanCache,
    ProgressUpdate,
    QueueFullError,
    ServiceClient,
    ServiceConfig,
    Ticket,
    UnsatisfiableRequestError,
)

__all__ = [
    "CANCELLED",
    "DEADLINE_EXCEEDED",
    "SHED",
    "TERMINAL_STATUSES",
    "CountingService",
    "PlanCache",
    "ProgressUpdate",
    "QueueFullError",
    "ServiceClient",
    "ServiceConfig",
    "Ticket",
    "UnsatisfiableRequestError",
]
