"""Utilities: metrics/observability."""

from .metrics import DecodeMetrics, StageTimer, get_metrics, reset_metrics

__all__ = ["DecodeMetrics", "StageTimer", "get_metrics", "reset_metrics"]
