"""writer_busy_ms_per_mbp.values: writer.batch spans a Mbp, value cells."""

from benchmark.program_trace import (  # noqa: F401
    writer_busy_ms_per_mbp as read)
