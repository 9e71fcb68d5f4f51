"""report_mbp_s: input Mbp of --report-only calls per second of the window."""

from benchmark.readers import mbp_s as read  # noqa: F401
