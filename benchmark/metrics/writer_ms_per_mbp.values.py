"""writer_ms_per_mbp.values: writer thread (report, binmax), value cells."""

from benchmark.readers import writer_ms_per_mbp as read  # noqa: F401
