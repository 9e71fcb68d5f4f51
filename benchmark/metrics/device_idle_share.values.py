"""device_idle_share.values: device layer, value cells."""

from benchmark.readers import device_idle_share as read  # noqa: F401
