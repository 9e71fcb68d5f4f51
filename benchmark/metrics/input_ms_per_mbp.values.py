"""input_ms_per_mbp.values: host input layer (fastx_batch, ScanEngine.stage), value cells."""

from benchmark.readers import input_ms_per_mbp as read  # noqa: F401
