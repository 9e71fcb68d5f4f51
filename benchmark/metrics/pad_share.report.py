"""pad_share.report: padded share of the lane slots (kernels), report cells."""

from benchmark.program_trace import (  # noqa: F401
    pad_share as read)
