"""writer_ms_per_mbp.report: writer thread (report, binmax), report cells."""

from benchmark.readers import writer_ms_per_mbp as read  # noqa: F401
