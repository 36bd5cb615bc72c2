"""Telemetry configuration (counterpart of ``repro.telemetry.config``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Switch for the run metrics (DESIGN.md §14).

    With ``enabled`` the engines keep per-agent staleness counters and an
    applied-update count on the device, snapshot the per-agent objective
    and staleness at the end of every record chunk, and attach the frames
    to the trace.  With ``enabled=False`` (or the engines' default
    ``telemetry=None``) the round bodies run exactly the operations they
    run without telemetry.
    """

    enabled: bool = False


def telemetry_on(telemetry) -> bool:
    """Normalize the engines' ``telemetry`` kwarg (None = off) to a bool."""
    return telemetry is not None and telemetry.enabled
