"""idle_input_share.report: card idle, main thread on input; report cells."""

from benchmark.program_trace import (  # noqa: F401
    idle_input_share as read)
