"""pad_share.values: padded share of the lane slots (kernels), value cells."""

from benchmark.program_trace import (  # noqa: F401
    pad_share as read)
