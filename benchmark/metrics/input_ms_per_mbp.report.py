"""input_ms_per_mbp.report: host input layer (fastx_batch, ScanEngine.stage), report cells."""

from benchmark.readers import input_ms_per_mbp as read  # noqa: F401
