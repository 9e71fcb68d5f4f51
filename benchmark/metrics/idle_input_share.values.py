"""idle_input_share.values: card idle, main thread on input; value cells."""

from benchmark.program_trace import (  # noqa: F401
    idle_input_share as read)
