"""The statistics the end-to-end metrics are taken with."""

from __future__ import annotations


def rate_per_hour(units: int, seconds: float) -> float:
    """Units completed over the whole window, per hour."""
    return units * 3600.0 / seconds
