"""device_idle_share.report: device layer, report cells."""

from benchmark.readers import device_idle_share as read  # noqa: F401
