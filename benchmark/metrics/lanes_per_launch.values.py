"""lanes_per_launch.values: staged lanes a scan launch (kernels), values."""

from benchmark.program_trace import (  # noqa: F401
    lanes_per_launch as read)
