"""What several per-layer readers share: the device's idle share of a
traced window."""

from __future__ import annotations

from typing import Optional


def device_idle(outcome) -> Optional[float]:
    """Per cent of the traced window in which no operation ran on the
    device (``timers.DeviceTrace``)."""
    t = outcome.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
