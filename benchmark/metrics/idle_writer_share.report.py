"""idle_writer_share.report: card idle, main thread on the writer; report."""

from benchmark.program_trace import (  # noqa: F401
    idle_writer_share as read)
