"""writer_busy_ms_per_mbp.report: writer.batch spans a Mbp, report cells."""

from benchmark.program_trace import (  # noqa: F401
    writer_busy_ms_per_mbp as read)
