"""The card's idle share of the traced window in the MSM cell."""

from benchmark.readers import device_idle_pct as read  # noqa: F401
