"""idle_writer_share.values: card idle, main thread on the writer; values."""

from benchmark.program_trace import (  # noqa: F401
    idle_writer_share as read)
